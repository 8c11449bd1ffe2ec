"""The DSN gate's CPU twin: tests/test_quality.py::TestDSNClosedLoop::
test_dsn_gate_tiny_trained_beats_untrained on the port
(cli/dsn_quality_gate.run_dsn_gate), at that test's sizes (300 steps, bs=2,
512 points, 2 held-out batches, the stage table of
tests/test_torch_dsn_train.py), from the JAX package's initial weights (the
gate's PRNGKey(0) init on make_batch(0)'s clouds, bridged by weights.py).

Bars: the JAX test's, unmoved (trained fg_iou > 0.7 and > untrained +
0.15; purity > 0.93 and > untrained); the margins are printed.
"""

import json

import jax
import jax.numpy as jnp

from graspbalance_tpu.data.synthetic import make_batch as j_make_batch
from graspbalance_tpu.models.dsn import DSN as JDSN
from graspbalance_tpu_torch.cli import dsn_quality_gate
from test_torch_dsn_train import BS, J_SCENE, MAX_OBJECTS, NUM_OBJECTS, NUM_POINTS, STAGES, _np_tree, _port_tree
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)


def test_dsn_gate_twin_from_jax_init():
    """tests/test_quality.py::TestDSNClosedLoop::test_dsn_gate_tiny_trained_beats_untrained
    on the port, from the JAX package's initial weights (the gate's PRNGKey(0)
    init on make_batch(0)'s clouds)."""
    model = JDSN(pt_stages=STAGES)
    cloud0 = jnp.asarray(j_make_batch(0, BS, J_SCENE)["point_clouds"][..., :3])
    variables = _np_tree(dict(jax.jit(lambda r, c: model.init(r, c, train=True))(jax.random.PRNGKey(0), cloud0)))
    res = dsn_quality_gate.run_dsn_gate(
        steps=300, bs=BS, num_points=NUM_POINTS, eval_batches=2, max_objects=MAX_OBJECTS,
        num_objects=NUM_OBJECTS, pt_stages=STAGES, log=lambda *_: None, device="cpu",
        initial_state=_port_tree(variables),
    )
    tr, un = res["trained"], res["untrained"]
    margins = {"fg_iou - 0.7": tr["fg_iou"] - 0.7, "fg_iou - (untrained + 0.15)": tr["fg_iou"] - un["fg_iou"] - 0.15,
               "purity - 0.93": tr["purity"] - 0.93, "purity - untrained": tr["purity"] - un["purity"]}
    print(json.dumps({"dsn_gate_twin": res, "margins": margins}))
    assert tr["fg_iou"] > 0.7, res
    assert tr["fg_iou"] > un["fg_iou"] + 0.15, res
    assert tr["purity"] > 0.93, res
    assert tr["purity"] > un["purity"], res
    assert set(res) == {"config", "steps", "bs", "train_wall_s", "untrained", "trained", "oracle", "trained_xdist",
                        "oracle_xdist"}
    assert res["oracle"]["fg_iou"] == 1.0
