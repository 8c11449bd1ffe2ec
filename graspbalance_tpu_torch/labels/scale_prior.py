"""Object-scale distribution prior for loss reweighting (a copy of
graspbalance_tpu/labels/scale_prior.py, which is numpy only: this package
imports nothing of the JAX package).

Dataset statistics reproduced from the reference's
ScaleDistribution/objects_scales.npy (a dict {num: 32 bin counts,
interval: 33 bin edges over grasp widths 0.003..0.1 m}), consumed by
TrainModel/loss.py:18-26 as weight = -log(n_bin / n_max) + 1. The values
are embedded here so the framework has no runtime dependency on the
reference checkout.
"""

import numpy as np

SCALE_BIN_COUNTS = np.array(
    [
        1485, 1214, 3983, 5132, 5351, 6246, 8498, 8951,
        10123, 13301, 15814, 22138, 20040, 21743, 22042, 23140,
        26960, 29436, 29675, 30826, 30801, 33987, 32947, 29472,
        29762, 31892, 33119, 27972, 27850, 27633, 32244, 39441,
    ],
    dtype=np.float64,
)

SCALE_BIN_EDGES = np.array(
    [
        0.0030035809613764286, 0.006034715610439889, 0.00906585025950335,
        0.01209698490856681, 0.01512811955763027, 0.01815925420669373,
        0.021190388855757192, 0.024221523504820652, 0.027252658153884113,
        0.030283792802947573, 0.033314927452011034, 0.036346062101074494,
        0.039377196750137955, 0.042408331399201415, 0.045439466048264876,
        0.04847060069732834, 0.0515017353463918, 0.05453286999545526,
        0.05756400464451872, 0.06059513929358218, 0.06362627394264564,
        0.0666574085917091, 0.06968854324077256, 0.07271967788983602,
        0.07575081253889948, 0.07878194718796294, 0.0818130818370264,
        0.08484421648608986, 0.08787535113515332, 0.09090648578421678,
        0.09393762043328024, 0.0969687550823437, 0.09999988973140717,
    ],
    dtype=np.float64,
)


def scale_prior_weights() -> np.ndarray:
    """(32,) float32 reweighting factors: -log(n/n_max) + 1 (loss.py:24-25)."""
    w = -np.log(SCALE_BIN_COUNTS / SCALE_BIN_COUNTS.max()) + 1.0
    return w.astype(np.float32)
