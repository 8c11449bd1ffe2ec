"""The port's point-axis-sharded DRP forward
(graspbalance_tpu_torch/parallel/backbone.py) against its unsharded DRP and
the JAX package's sharded_drp_forward, on the JAX test's tiny stage table
(tests/test_sharded_ops.py: DRP_STAGES' structure, every npoint split
evenly), 2 clouds of 1,024 points, random weights from a seed (numpy).

The port runs on four gloo ranks on the CPU, a (2, 2) ('data', 'point')
mesh (parallel/ranks.py, one torch thread a rank, a ``file://`` store
under tmp_path): each data coordinate holds one cloud, split in two along
its points. The JAX function runs on a (2, 2) mesh of the virtual CPU
devices. Every point rank of a data coordinate must return the same dict.

Tolerances: the indices and coordinates exactly (FPS, the queries and the
gathers are exact on both sides); the features within FEAT_TOL = 1e-6 of
the port's unsharded forward (the JAX test's tolerance: each output row
runs the same operations, only products over fewer rows may round apart),
and within JAX_TOL = 1e-6 of the JAX sharded forward (the port's forward
against the JAX package's, which rounds some products in another order:
at most 7.8e-7 on features up to 1.4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspbalance_tpu.models.drp import DRP as JDRP
from graspbalance_tpu.parallel.backbone import sharded_drp_forward as j_sharded_drp_forward
from graspbalance_tpu.parallel.mesh import make_mesh as j_make_mesh
from graspbalance_tpu_torch.models.drp import DRP
from graspbalance_tpu_torch.parallel.ranks import run_ranks
from graspbalance_tpu_torch.weights import load_flax_variables
from test_torch_variants import _vars
from torch_ranks import backbone_ranks
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

FEAT_TOL = 1e-6
JAX_TOL = 1e-6
STAGES = (  # tests/test_sharded_ops.py's
    (128, 0.1, 16, (16, 16, 32), 2, 0.2, 16),
    (64, 0.2, 8, (16, 16, 32), 2, 0.3, 8),
    (32, 0.3, 8, (16, 16, 32), 1, 0.4, 8),
    (16, 0.4, 8, (16, 16, 32), 1, 0.5, 8),
)
NUM_SEED = 64
INDEX_KEYS = ("sa1_inds", "fp2_inds")
XYZ_KEYS = ("input_xyz", "sa1_xyz", "sa2_xyz", "sa3_xyz", "sa4_xyz", "fp2_xyz")
FEATURE_KEYS = ("sa1_features", "sa2_features", "sa3_features", "sa4_features", "fp2_features")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's sharded forward, its unsharded forward, the JAX sharded
    forward), each a dict of numpy arrays over both clouds."""
    tmp = tmp_path_factory.mktemp("parallel_backbone")
    rng = np.random.default_rng(0)
    pts = (rng.random((2, 1024, 3), dtype=np.float32) - 0.5)
    jdrp = JDRP(stages=STAGES, num_seed=NUM_SEED)
    variables = _vars(jdrp, jnp.asarray(pts), train=False)
    with j_make_mesh(2, 2) as mesh:
        jgot = jax.jit(lambda v, p: j_sharded_drp_forward(mesh, jdrp, v, p))(variables, jnp.asarray(pts))
    jgot = {k: np.asarray(v) for k, v in jgot.items() if v is not None}

    drp = load_flax_variables(DRP(STAGES, num_seed=NUM_SEED), variables).eval()
    with torch.no_grad():
        want = {k: v.numpy() for k, v in drp(torch.from_numpy(pts)).items() if v is not None}
    torch.save({"stages": STAGES, "num_seed": NUM_SEED, "drp": drp.state_dict(), "pts": torch.from_numpy(pts)},
               tmp / "in.pt")
    run_ranks(backbone_ranks, 4, (str(tmp / "in.pt"), str(tmp)), init_file=str(tmp / "store"), threads=1,
              timeout=240)
    by_row = {}
    for r in range(4):
        res = torch.load(tmp / f"rank{r}.pt")
        first = by_row.setdefault(res["data_rank"], res["out"])
        for k, v in res["out"].items():  # replicated over 'point'
            torch.testing.assert_close(v, first[k], rtol=0, atol=0, msg=k)
    got = {k: torch.cat([by_row[r][k] for r in sorted(by_row)]).numpy() for k in by_row[0]}
    return got, want, jgot


def test_sharded_drp_returns_the_unsharded_keys(runs):
    got, want, jgot = runs
    assert got.keys() == want.keys() == jgot.keys()
    for k in got:
        assert got[k].shape == want[k].shape == jgot[k].shape, k


@pytest.mark.parametrize("key", INDEX_KEYS + XYZ_KEYS)
def test_sharded_drp_indices_and_xyz_exact(runs, key):
    got, want, jgot = runs
    np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got[key], jgot[key])


@pytest.mark.parametrize("key", FEATURE_KEYS)
def test_sharded_drp_features(runs, key):
    got, want, jgot = runs
    np.testing.assert_allclose(got[key], want[key], rtol=FEAT_TOL, atol=FEAT_TOL)
    err = float(np.abs(got[key] - jgot[key]).max())
    print(f"{key}: max |port - JAX| {err:.3g}, max |JAX| {float(np.abs(jgot[key]).max()):.3g}")
    np.testing.assert_allclose(got[key], jgot[key], rtol=JAX_TOL, atol=JAX_TOL)
