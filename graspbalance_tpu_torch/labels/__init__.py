"""Grasp label geometry, label matching, the losses (the grasp model's and
the DSN's seg losses) and the analytic synthetic labels."""
