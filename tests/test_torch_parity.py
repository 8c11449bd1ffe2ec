"""Numerical parity vs torch for the building blocks the reference trains
with: BatchNorm (momentum convention, biased/unbiased variance split) and
the OneCycle LR schedule. torch (CPU) is available in the image."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from graspbalance_tpu.nn.layers import BatchNorm
from graspbalance_tpu.labels.geometry import (
    batch_viewpoint_params_to_matrix,
    generate_grasp_views_np,
)
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)


class TestBatchNormParity:
    def test_forward_and_running_stats(self, rng):
        x = rng.standard_normal((4, 50, 16)).astype(np.float32) * 2 + 1
        momentum = 0.37

        tbn = torch.nn.BatchNorm1d(16, momentum=momentum)
        tbn.train()
        with torch.no_grad():
            tbn.weight.copy_(torch.arange(1, 17) * 0.1)
            tbn.bias.copy_(torch.arange(16) * 0.01)
        tx = torch.from_numpy(x).permute(0, 2, 1)  # (B, C, N)
        tout = tbn(tx).permute(0, 2, 1).detach().numpy()

        bn = BatchNorm()
        variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
        variables = {
            "params": {
                "scale": jnp.arange(1, 17, dtype=jnp.float32) * 0.1,
                "bias": jnp.arange(16, dtype=jnp.float32) * 0.01,
            },
            "batch_stats": variables["batch_stats"],
        }
        jout, mutated = bn.apply(
            variables, jnp.asarray(x), train=True, momentum=momentum,
            mutable=["batch_stats"],
        )
        np.testing.assert_allclose(np.asarray(jout), tout, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(
            np.asarray(mutated["batch_stats"]["mean"]),
            tbn.running_mean.numpy(), rtol=1e-4, atol=1e-6,
        )
        np.testing.assert_allclose(
            np.asarray(mutated["batch_stats"]["var"]),
            tbn.running_var.numpy(), rtol=1e-4, atol=1e-6,
        )

    def test_eval_uses_running_stats(self, rng):
        x = rng.standard_normal((2, 20, 8)).astype(np.float32)
        bn = BatchNorm()
        v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
        stats = {
            "mean": jnp.asarray(rng.standard_normal(8).astype(np.float32)),
            "var": jnp.asarray(rng.random(8).astype(np.float32) + 0.5),
        }
        out = bn.apply(
            {"params": v["params"], "batch_stats": stats},
            jnp.asarray(x), train=False,
        )
        want = (x - np.asarray(stats["mean"])) / np.sqrt(
            np.asarray(stats["var"]) + 1e-5
        )
        np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4, atol=1e-5)


class TestOneCycleParity:
    def test_matches_torch_onecycle(self):
        from graspbalance_tpu.train.train_step import onecycle_schedule

        total = 200
        peak = 1e-3
        sched = onecycle_schedule(total, peak)
        m = torch.nn.Linear(2, 2)
        opt = torch.optim.SGD(m.parameters(), lr=peak)
        tsched = torch.optim.lr_scheduler.OneCycleLR(
            opt, max_lr=peak, total_steps=total
        )
        torch_lrs = []
        for _ in range(total):
            torch_lrs.append(opt.param_groups[0]["lr"])
            opt.step()
            tsched.step()
        jax_lrs = [float(sched(i)) for i in range(total)]
        # f32 schedule vs torch's f64: tiny tail-end values differ in ulps
        np.testing.assert_allclose(jax_lrs, torch_lrs, rtol=1e-4, atol=1e-10)


class TestGeometryParityTorchFree:
    def test_viewpoint_matrix_against_reference_formula(self, rng):
        """Literal numpy transcription of loss_utils.py:33-49."""
        towards = rng.standard_normal((40, 3)).astype(np.float32)
        angle = (rng.random(40).astype(np.float32) - 0.5) * 6
        got = np.asarray(
            batch_viewpoint_params_to_matrix(jnp.asarray(towards), jnp.asarray(angle))
        )
        for i in range(40):
            ax = towards[i].astype(np.float64)
            ay = np.array([-ax[1], ax[0], 0.0])
            if np.linalg.norm(ay) == 0:
                ay = np.array([0.0, 1.0, 0.0])
            ax_n = ax / np.linalg.norm(ax)
            ay_n = ay / np.linalg.norm(ay)
            az = np.cross(ax_n, ay_n)
            c, s = np.cos(angle[i]), np.sin(angle[i])
            r1 = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
            r2 = np.stack([ax_n, ay_n, az], axis=-1)
            np.testing.assert_allclose(got[i], r2 @ r1, atol=1e-5)

    def test_fibonacci_views_unit_and_spread(self):
        v = generate_grasp_views_np(300)
        np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, atol=1e-5)
        # z coverage is uniform by construction
        np.testing.assert_allclose(
            np.sort(v[:, 2]), (2 * np.arange(300) + 1) / 300 - 1, atol=1e-6
        )
