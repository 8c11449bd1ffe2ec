"""The benchmark's own counts of operations and bytes, and the card's peaks."""
