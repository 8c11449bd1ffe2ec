"""How far apart two float32 forwards of the full DRP stage table are at
flax's initialisation: the JAX package's and the port's (same weights,
same batch), and the port's in float32 against float64, on a 4,096-point
gate scene (300 views, 1,024 seeds, 1,024 label points).

    JAX_PLATFORMS=cpu python tests/full_stage_precision.py

Prints, per end point, the largest difference over the largest |value| of
the reference (the JAX package, then the port in float64). When the two
rows read alike, the gap between the packages is float32 rounding
amplified by the forward, not a difference of formula.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from graspbalance_tpu.data.synthetic import SceneConfig as JSceneConfig  # noqa: E402
from graspbalance_tpu.data.synthetic import make_batch as j_make_batch  # noqa: E402
from graspbalance_tpu.train import train_step as jts  # noqa: E402
from graspbalance_tpu.train.config import Config as JConfig  # noqa: E402
from graspbalance_tpu.train.config import DataConfig as JDataConfig  # noqa: E402
from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_batch  # noqa: E402
from graspbalance_tpu_torch.train.config import Config, DataConfig  # noqa: E402
from graspbalance_tpu_torch.train.train_step import (  # noqa: E402
    _maybe_expand_analytic,
    build_model,
    set_bn_momentum,
    to_device,
)
from graspbalance_tpu_torch.weights import state_dict_from_flax  # noqa: E402

SCENE = dict(num_points=4096, analytic_labels=True, emit_label_tensors=False, table_extent=0.15, object_scatter=0.12,
             max_grasp_points=1024, grasp_points_per_object=100)
KEYS = ("sa1_features", "sa2_features", "sa3_features", "sa4_features", "fp2_features", "objectness_score",
        "view_score")
MOMENTUM = 0.5


def port_forward(state_dict, dtype, cfg, scene):
    model = build_model(cfg, device="cpu").to(dtype)
    model.load_state_dict({k: v.to(dtype) for k, v in state_dict.items()})
    batch = _maybe_expand_analytic(to_device(make_batch(1, 2, scene), "cpu"), cfg)
    batch = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in batch.items()}
    set_bn_momentum(model, MOMENTUM)
    model.train()
    with torch.no_grad():
        ep = model.forward_train(batch)
    return {k: ep[k].double().numpy() for k in KEYS}


def main():
    jcfg, cfg = JConfig(data=JDataConfig(analytic_labels=True)), Config(data=DataConfig(analytic_labels=True))
    jscene, scene = JSceneConfig(**SCENE), SceneConfig(**SCENE)
    jmodel, state = jts.create_train_state(jcfg, 1, j_make_batch(0, 2, jscene))
    variables = jax.tree_util.tree_map(np.array, {"params": state.params, "batch_stats": state.batch_stats})
    jbatch = jts._maybe_expand_analytic({k: jnp.asarray(v) for k, v in j_make_batch(1, 2, jscene).items()}, jcfg)
    jep, _ = jax.jit(lambda b: jmodel.apply(variables, b, train=True, bn_momentum=MOMENTUM,
                                            mutable=["batch_stats"]))(jbatch)
    jax_ep = {k: np.asarray(jep[k], np.float64) for k in KEYS}
    sd = state_dict_from_flax(variables, build_model(cfg, device="cpu"))
    p32, p64 = port_forward(sd, torch.float32, cfg, scene), port_forward(sd, torch.float64, cfg, scene)
    for k in KEYS:
        vs_jax = np.abs(p32[k] - jax_ep[k]).max() / np.abs(jax_ep[k]).max()
        vs_64 = np.abs(p32[k] - p64[k]).max() / np.abs(p64[k]).max()
        print(f"{k:18s} port f32 against JAX f32 {vs_jax:.3g}; port f32 against port f64 {vs_64:.3g}")


if __name__ == "__main__":
    main()
