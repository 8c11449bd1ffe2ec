"""End-to-end inference pipeline (port of graspbalance_tpu/eval/pipeline.py):

  cloud -> [FPS shared -> DSN -> mean-shift cluster] -> GraspBalance forward
  with object-balanced re-seeding -> pred_decode -> grasp NMS -> voxel
  downsample -> collision filter -> (grasps (B, Ns, 17), keep (B, Ns)).

Everything up to the final host copy runs on ``device``, which defaults to
the card: ``GraspInference`` raises when no CUDA device is present unless
the caller passes ``device="cpu"`` (where every kernel runs its plain
version). Each stage of a call is a span of ``trace.py`` (``gb.call`` over
``gb.upload``, ``gb.segment``, ``gb.model``, ``gb.decode``,
``gb.postprocess`` and ``gb.copy_out``), and the upload and the copies out
are its ``host_read`` sites. ``to_grasp_group_array`` emits graspnetAPI's
17-column GraspGroup rows, and ``dump_dataset`` writes them for a dataset
split in the layout graspnetAPI's evaluation reads.
"""

from __future__ import annotations

import numpy as np
import torch

from graspbalance_tpu_torch import trace
from graspbalance_tpu_torch.eval.collision import collision_detect, voxel_downsample_fixed
from graspbalance_tpu_torch.eval.nms import grasp_nms
from graspbalance_tpu_torch.models.decode import pred_decode
from graspbalance_tpu_torch.models.dsn import cluster
from graspbalance_tpu_torch.ops.fps import furthest_point_sample, furthest_point_sample_plain


def make_postprocess(collision_thresh: float = 0.05):
    """The post-decode stack, batched: grasp NMS, then the collision filter
    against the 5 mm voxel-downsampled scene.

    Returns ``postprocess(grasps (B, G, 17), valid (B, G), scene (B, N, 3),
    *, plain=False) -> keep (B, G) bool``; ``plain`` runs the collision
    counts' plain version. Spans ``gb.nms``, ``gb.voxel``, ``gb.collision``."""

    def postprocess(grasps, valid, scene, *, plain: bool = False):
        with trace.span("gb.nms"):
            keep = grasp_nms(grasps, valid)
        with trace.span("gb.voxel"):
            s_ds, s_valid = voxel_downsample_fixed(scene)
        with trace.span("gb.collision"):
            coll = collision_detect(
                s_ds, grasps, scene_valid=s_valid, collision_thresh=collision_thresh, plain=plain
            )
            return keep & ~coll

    return postprocess


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return device


class GraspInference:
    """A GraspBalance model (+ optional DSN for OBS) for scene inference.

    ``model`` and ``dsn`` are the port's modules with their weights loaded;
    they are moved to ``device`` and put in eval mode."""

    def __init__(
        self,
        model,
        dsn=None,
        *,
        use_obs: bool = False,
        collision_thresh: float = 0.05,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.dsn = dsn.to(self.device).eval() if dsn is not None else None
        self.use_obs = use_obs and dsn is not None
        self.collision_thresh = collision_thresh
        self.postprocess = make_postprocess(collision_thresh)
        if self.use_obs:
            # one FPS serves both networks: greedy FPS re-traces itself, so
            # the DSN's stage-0 sample and the model backbone's are prefixes
            # of one run over the same cloud; the backbone says how long its
            # own is (``fps_prefix``)
            self.n0_dsn = dsn.pt_stages[0][0]
            self.n0_model = model.backbone.fps_prefix(model.backbone.stages)

    def sample(self, cloud: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
        """The shared FPS of both networks: (B, max(n0_dsn, n0_model)) int32."""
        fps = furthest_point_sample_plain if plain else furthest_point_sample
        return fps(cloud[..., :3].contiguous(), max(self.n0_dsn, self.n0_model))

    def segment(self, cloud: torch.Tensor, *, generator=None, gumbel=None, plain: bool = False):
        """The shared FPS, then the DSN + mean-shift half of OBS: (labels
        (B, N) int32, sa_inds (B, n0_model) int32). The mean-shift noise is
        ``gumbel``, or is drawn from ``generator`` (default: a generator on
        the device seeded 0)."""
        with trace.span("gb.segment"):
            xyz = cloud[..., :3].contiguous()
            with trace.span("gb.fps"):
                sa_full = self.sample(xyz, plain=plain)
            with trace.span("gb.dsn"):
                ep = self.dsn(cloud, sa_inds=sa_full[:, : self.n0_dsn], plain=plain)
                fg = torch.argmax(ep["foreground_logits"], dim=-1) == 1
            with trace.span("gb.cluster"):
                if gumbel is None and generator is None:
                    generator = torch.Generator(device=self.device).manual_seed(0)
                labels, _, _ = cluster(xyz, ep["center_offsets"], fg, gumbel=gumbel, generator=generator)
            return labels, sa_full[:, : self.n0_model]

    def forward(self, cloud: torch.Tensor, *, generator=None, gumbel=None, plain: bool = False) -> dict:
        """The model's end points, re-seeded by OBS when ``use_obs``."""
        kw = {}
        if self.use_obs:
            labels, sa_inds = self.segment(cloud, generator=generator, gumbel=gumbel, plain=plain)
            kw = {"seed_cluster": labels, "sa_inds": sa_inds}
        with trace.span("gb.model"):
            return self.model(cloud, plain=plain, **kw)

    @torch.no_grad()
    def __call__(self, cloud, *, generator=None, gumbel=None):
        """cloud (B, N, 3) (numpy or tensor) -> (grasps (B, Ns, 17) numpy,
        keep (B, Ns) numpy bool)."""
        with trace.span("gb.call"):
            with trace.span("gb.upload"):
                host = torch.as_tensor(cloud, dtype=torch.float32)
                cloud = trace.host_read("upload", lambda: host.to(self.device))
            ep = self.forward(cloud, generator=generator, gumbel=gumbel)
            with trace.span("gb.decode"):
                grasps, valid = pred_decode(ep)
            with trace.span("gb.postprocess"):
                keep = self.postprocess(grasps, valid, cloud[..., :3])
            with trace.span("gb.copy_out"):
                grasps, keep = trace.host_read("copy_out", grasps.cpu), trace.host_read("copy_out", keep.cpu)
            return grasps.numpy(), keep.numpy()


def to_grasp_group_array(grasps: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """(Ns, 17), (Ns,) -> (G, 17) float32 rows in graspnetAPI GraspGroup
    column order [score, width, height, depth, rotation(9), translation(3),
    object_id]."""
    return grasps[keep].astype(np.float32)


def dump_dataset(infer: GraspInference, ds, dump_dir: str, camera: str, batch_size: int = 4, max_frames: int = 0,
                 log=print) -> int:
    """Run ``infer`` over a GraspNetDataset (``load_label=False``) and write
    each frame's (G, 17) rows in graspnetAPI's GraspNetEval layout,
    ``dump_dir/scene_xxxx/<camera>/xxxx.npy``. Returns the frames written."""
    import os

    from graspbalance_tpu_torch.data.dataset import collate

    os.makedirs(dump_dir, exist_ok=True)
    n = len(ds) if not max_frames else min(len(ds), max_frames)
    for i in range(0, n, batch_size):
        frames = range(i, min(i + batch_size, n))
        batch = collate([ds[j] for j in frames])
        grasps, keep = infer(batch["point_clouds"])
        for j, item_idx in enumerate(frames):
            scene, frame = ds.samples[item_idx]
            out_dir = os.path.join(dump_dir, scene, camera)
            os.makedirs(out_dir, exist_ok=True)
            np.save(os.path.join(out_dir, f"{frame:04d}.npy"), to_grasp_group_array(grasps[j], keep[j]))
        if (i // batch_size) % 10 == 0:
            log(f"{i + len(frames)}/{n}")
    return n
