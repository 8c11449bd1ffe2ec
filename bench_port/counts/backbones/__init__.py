"""Operation counts of the backbones, one file each, ``<name>.py``, found by
the configuration's ``model.backbone`` name (``counts/model.py``). Each
defines ``forward(stages, batch, num_points)``: the products of the
backbone's forward pass at those shapes, counted as ``counts/model.py``
counts them (``mlp``)."""
