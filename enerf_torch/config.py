"""Typed configuration, compatible with the reference's configargparse files.

The port's own copy of enerf_tpu/config.py: the same fields, the same
`key = value` parsing and the same `-O` handling, so every config of the
repo parses unchanged.  Two additions: `TPU_ONLY` names the options that
select TPU variants or TPU dispatch machinery (accepted, ignored by the
port), and `check_supported` raises on options whose code path the port
does not have yet.
"""

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Config:
    # dataset / logging
    config: Optional[str] = None
    outdir: str = "output"
    expweek: str = "testweek"
    expname: str = "testname"
    datadir: str = "data"
    train_idxs: Optional[List[int]] = None
    val_idxs: Optional[List[int]] = None
    test_idxs: Optional[List[int]] = None
    exclude_idxs: Optional[List[int]] = None
    test: bool = False
    seed: int = 0
    disable_view_direction: int = 0
    out_dim_color: int = 1

    # event-related
    hotpixs: int = 0
    e2vid: int = 0
    events: int = 0
    event_only: int = 0
    accumulate_evs: int = 0
    acc_max_num_evs: int = 0
    use_luma: int = 1
    linlog: int = 1
    batch_size_evs: int = 4096
    C_thres: float = 0.5
    images_corrupted: int = 0
    log_implicit_C_thres: int = 1
    negative_event_sampling: int = 0
    epoch_start_noEvLoss: int = 0
    weight_loss_rgb: float = 1.0
    w_no_ev: float = 1.0
    precompute_evs_poses: int = 1

    # training
    iters: int = 1000000
    ckpt: str = "latest"
    lr: float = 1e-3
    eval_interval: int = 10
    num_rays: int = 4096
    cuda_ray: bool = False  # kept name for config compat: occupancy-march path
    num_steps: int = 512
    upsample_steps: int = 0
    max_ray_batch: int = 4096
    eval_stereo_views: int = 0
    pp_poses_sphere: int = 1
    render_mode: int = 0

    # backbone
    fp16: bool = False  # on TPU this selects bf16 compute
    ff: bool = False    # fused-MLP pallas path
    tcnn: bool = False  # alias of ff on TPU (no tiny-cuda-nn)
    # positional encoding (reference encoding.py get_encoder): 'auto'
    # follows --ff/--tcnn (blockgrid) vs hashgrid; 'frequency'/'none' are
    # the grid-free encoders.
    encoding: str = "auto"  # auto | hashgrid | blockgrid | frequency | none

    # dataset options
    mode: str = "esim"
    color_space: str = "srgb"
    preload: bool = False
    bound: float = 2.0
    scale: float = 0.33
    downscale: int = 1
    dt_gamma: float = 0.0
    min_near: float = 0.2
    density_thresh: float = 0.01
    density_scale: float = 1.0
    bg_radius: float = -1.0

    # GUI / viewer
    gui: bool = False
    W: int = 1920
    H: int = 1080
    radius: float = 5.0
    fovy: float = 50.0
    max_spp: int = 64

    # experimental
    error_map: bool = False
    clip_text: str = ""
    rand_pose: int = -1

    # TPU-specific additions (not in the reference)
    mesh_shape: Optional[List[int]] = None  # devices per ('data',) axis; None = all
    multihost: int = 0          # pod-slice run: jax.distributed.initialize +
                                # mesh over ALL processes' devices; file
                                # writes gated to process 0 (parallel/multihost.py)
    log_every: int = 100
    max_keep_ckpt: int = 2
    march_samples: int = 64     # live-sample buffer per ray (march path)
    compact_frac: float = 0.5   # per-ray compaction budget fraction
    max_steps: int = 1024       # march step budget (reference renderer.py:281)
    share_march: int = 0        # event pairs share one march (variance cut)
    syn_frames: int = 40        # synthetic-mode simulator frames
    syn_rich: int = 0           # synthetic scene richness: 1 = ring of
                                # high-contrast blobs, 2 = + textured
                                # albedo/floor (events then constrain most
                                # pixels, like the reference's real scenes)
    fuse_steps: int = 16        # train steps fused into one XLA program
                                # (matches the 16-step occupancy cadence;
                                # 1 = dispatch per step)
    grid_block: int = 4         # blockgrid row geometry (4: 1KB rows with
                                # 5^3 halo, 3: 512B rows — halves the
                                # byte-bound scatter-add backward)
    num_levels: int = 16        # grid encoder levels (reference hard-codes
    level_dim: int = 2          # 16x2, network.py:35-43; exposed here for
                                # the TPU-first gather-count ablation:
                                # 8 levels x 4 feats halves the per-sample
                                # address-bound gathers at equal output dim)
    bf16_gather: int = -1       # blockgrid row gathers in bf16 (-1/0:
                                # off — measured slower on v5e, the gather
                                # is address-rate bound; 1: opt in.
                                # ops/blockgrid.block_encode_bf16)
    debug_nan: int = 0          # NaN sanitizer: 1 = dump param norms +
                                # abort at the first non-finite loss;
                                # 2 = also enable jax_debug_nans (traps the
                                # producing op; slow). 0 = log-only sentinel
    mxu_grad: int = 0           # MXU-routed blockgrid encode
                                # (ops/blockgrid.block_encode_mxu): coarse
                                # levels via exact one-hot matmuls, fine
                                # backward scatter run-merged. 1 = on.
    mxu_rows: int = 2048        # n_rows threshold for the matmul routing
    coalesce_rounds: int = 3    # pairwise run-merge passes on the fine
                                # scatter stream (0: off)
    segsum_grad: int = 0        # blockgrid table backward via sort +
                                # prefix-sum segment reduce + sorted-unique
                                # scatter (ops/blockgrid.block_encode_segsum)
                                # instead of XLA's duplicate-index
                                # scatter-add. 1 = on.
    position_grads: int = 0     # with segsum_grad: also compute exact
                                # dL/dposition (reference dy_dx path,
                                # gridencoder.cu:176-221); plain
                                # hashgrid/blockgrid autodiff paths give
                                # position grads regardless
    w_distortion: float = 0.0   # mip-NeRF-360 distortion regularizer on
                                # event-ray sample weights (march path) —
                                # collapses the diffuse-mist density mode
                                # (train/step.py distortion_loss). 0 = off.
    remat_fixed: int = 0        # rematerialize the fixed-step renderer in
                                # backward (jax.checkpoint) — ~4x lower AD
                                # residual memory per step.  0 = off
                                # (march_warmup phases still auto-enable
                                # full remat, train/step.warm_statics);
                                # 1 = full remat (backward re-runs the
                                # encode gathers); 2 = save-encode policy
                                # (keeps the encode output, skips the
                                # gather re-run — faster when it fits).
    w_opacity: float = 0.0      # opacity binary-entropy regularizer on
                                # event rays (BEYOND reference — breaks the
                                # transparent-mist gauge mode of
                                # consecutive-pair supervision; see
                                # ROUND2_STATUS.md).  0 = off.
    density_bias: float = 0.0   # density-logit bias: sigma0 ~ e^bias at
                                # init, making the march start opaque and
                                # CARVE like the reference's 512-uniform-
                                # sample path (models/field.py)
    march_warmup: int = 0       # train the FIRST N iters with the uniform
                                # fixed-step renderer (num_steps samples, no
                                # occupancy culling) before switching to the
                                # march path.  Motivation: the march's
                                # occupancy feedback reinforces the
                                # transparent-mist gauge mode; uniform
                                # sampling carves real geometry first
                                # (quality_r2d J_fixed, ROUND2_STATUS.md)
    warmup_num_steps: int = 0   # fixed-step sample count DURING the warmup
                                # phase only (0 = use num_steps).  The warmup
                                # renderer is encoder-gather bound — 4
                                # renders x num_rays x num_steps samples per
                                # step — so halving the warmup sample count
                                # nearly halves warmup wall-clock while the
                                # march phase keeps full num_steps for eval
    occ_freeze_after: int = 0   # if > 0, stop occupancy-grid EMA updates
                                # once global_step >= this value: the grid
                                # stays frozen as last carved.  Breaks the
                                # march's occupancy<->density feedback loop
                                # (round-4 measured: a 0.19-occupied warm
                                # carve re-mists to 0.62 within 2k march
                                # steps when updates keep running —
                                # ROUND4_STATUS.md / BENCH_NOTES round 4).
                                # NOTE: in chunked mode (chunk_len > 1) the
                                # freeze is evaluated at window boundaries,
                                # so the effective freeze point rounds UP by
                                # up to chunk_len-1 steps vs the per-step
                                # path; set it to a multiple of chunk_len
                                # when A/B-comparing the two execution paths
    ckpt_interval: int = 1      # epochs between rotating checkpoint saves
                                # (each save pulls the full train state to
                                # host — costly over a remote-TPU link)
    profile: int = 0            # capture a jax.profiler trace of ~N train
                                # steps (after N warmup steps) into
                                # <workspace>/profile; 0 = off
    async_ckpt: int = 0         # overlap checkpoint saves with training:
                                # device->host copies start async and the
                                # npz write runs on a worker thread
                                # (train/checkpoints.py CheckpointManager;
                                # saves are atomic tmp+rename, readers
                                # wait() for in-flight saves)
    hidden_dim: int = 64        # sigma-net width (reference hard-codes 64,
    hidden_dim_color: int = 64  # network.py:28/58; exposed because on TPU
    geo_feat_dim: int = 15      # the MLPs are <1% of step time — wider
                                # nets are a free quality lever,
                                # BENCH_NOTES.md "Implications")
    guard_collapse: int = 0     # divergence guard (VERDICT r4 weak 1: the
                                # R4a flagship burned 50 epochs training
                                # into washout collapse).  If 1: halt
                                # training once the eval-time collapse
                                # telemetry fires — guard_patience
                                # consecutive evals with either the
                                # corrected PSNR >= guard_psnr_drop dB
                                # below the best seen, or (event_only)
                                # affine gain a < guard_affine_a.  The
                                # best-metric checkpoint is already saved,
                                # so halting preserves the peak
    guard_patience: int = 2     # consecutive bad evals before halting
    guard_psnr_drop: float = 2.0
    guard_affine_a: float = 0.4  # washout indicator: R4a's collapse ran
                                # a 1.02 -> 0.20 while converged runs sit
                                # near 1 (output/quality_r4 log, VERDICT)
    eval_log: str = ""          # append one JSON line per eval to this
                                # file (durability: VERDICT r4 weak 5 —
                                # machine resets wiped completed eval
                                # series twice; point this at a git-tracked
                                # results/ file and commit at eval cadence,
                                # scripts/commit_results.sh)

    def validate(self):
        """reference main_nerf.py:78-93 assert_config (with messages)."""
        assert self.acc_max_num_evs >= 0, (
            f"acc_max_num_evs must be >= 0, got {self.acc_max_num_evs}"
        )
        assert self.march_warmup >= 0, (
            f"march_warmup must be >= 0, got {self.march_warmup}"
        )
        assert self.warmup_num_steps >= 0, (
            f"warmup_num_steps must be >= 0, got {self.warmup_num_steps} "
            "(0 = use num_steps during the warmup phase)"
        )
        assert self.occ_freeze_after >= 0, (
            f"occ_freeze_after must be >= 0, got {self.occ_freeze_after}"
        )
        if self.mode == "eds":
            assert self.pp_poses_sphere == 0, (
                "mode=eds requires pp_poses_sphere=0 (EDS poses are already "
                "metric; sphere preprocessing would distort them)"
            )
        assert 1e-7 < self.lr < 1e2, f"lr {self.lr} outside (1e-7, 1e2)"
        if self.event_only:
            assert self.events, "event_only=1 requires events=1"
        if self.mode not in ("tumvie", "eds"):
            assert self.eval_stereo_views == 0, (
                f"eval_stereo_views needs a stereo dataset (tumvie/eds), "
                f"mode is {self.mode!r}"
            )
        assert self.out_dim_color in (1, 3), (
            f"out_dim_color must be 1 or 3, got {self.out_dim_color}"
        )
        if self.out_dim_color == 1 and self.use_luma:
            # grayscale output IS luma — the flag is meaningless; the
            # reference hard-asserts here on its own defaults
            # (main_nerf.py:91-92 vs :117/:126), we coerce instead
            self.use_luma = 0
        return self


# TPU variants of one function or TPU dispatch machinery: configs keep
# parsing, the port runs its single implementation and logs that it
# ignored them (train/trainer.py).
TPU_ONLY = ("fuse_steps", "mesh_shape", "multihost", "bf16_gather",
            "segsum_grad", "mxu_grad", "mxu_rows", "coalesce_rounds")


def check_supported(cfg):
    """Raise NotImplementedError for options the port cannot run yet."""
    missing = []
    if not cfg.events:
        missing.append("events=0 (frames mode)")
    if cfg.encoding in ("frequency", "none"):
        missing.append(f"encoding={cfg.encoding}")
    if cfg.bg_radius > 0:
        missing.append("bg_radius > 0 (background net)")
    if cfg.mode != "synthetic":
        missing.append(f"mode={cfg.mode} (dataset loaders)")
    if cfg.rand_pose >= 0:
        missing.append("rand_pose (CLIP step)")
    if cfg.error_map:
        missing.append("error_map")
    if missing:
        raise NotImplementedError(
            "enerf_torch does not support yet: " + ", ".join(missing))
    return cfg


_BOOL_FIELDS = {
    f.name for f in dataclasses.fields(Config) if f.type in ("bool", bool)
}
_LIST_FIELDS = {"train_idxs", "val_idxs", "test_idxs", "exclude_idxs", "mesh_shape"}


def _parse_value(name, raw, target_type):
    raw = raw.strip()
    if name in _LIST_FIELDS:
        raw = raw.strip("[]")
        return [int(v) for v in raw.replace(",", " ").split()] if raw else []
    if name in _BOOL_FIELDS:
        return raw.lower() in ("1", "true", "yes")
    if raw == "None":
        return None
    for typ in (int, float):
        if target_type is typ:
            return typ(raw)
    return raw


def load_config_file(path):
    """Parse a reference-format `key = value` config txt into a dict."""
    out = {}
    types = {f.name: f.type for f in dataclasses.fields(Config)}
    py_types = {f.name: _field_pytype(f) for f in dataclasses.fields(Config)}
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, raw = line.split("=", 1)
            key = key.strip()
            if key not in types:
                continue  # unknown keys ignored (forward compat)
            out[key] = _parse_value(key, raw, py_types[key])
    return out


def _field_pytype(f):
    t = f.type
    if t in ("int", int):
        return int
    if t in ("float", float):
        return float
    if t in ("bool", bool):
        return bool
    return str


def build_config(argv=None):
    """CLI entry: --config file + flag overrides (reference main_nerf.py)."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", type=str, default=None)
    pre.add_argument("-O", action="store_true", dest="O_flag")
    known, _ = pre.parse_known_args(argv)

    cfg_kwargs = {}
    if known.config:
        cfg_kwargs = load_config_file(known.config)
        cfg_kwargs["config"] = known.config

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("-O", action="store_true", dest="O_flag")
    for f in dataclasses.fields(Config):
        if f.name == "config":
            continue
        name = f"--{f.name}"
        if f.name in _LIST_FIELDS:
            parser.add_argument(name, type=int, action="append", default=None)
        elif f.name in _BOOL_FIELDS:
            parser.add_argument(name, action="store_true", default=None)
        else:
            parser.add_argument(name, type=_field_pytype(f), default=None)
    args = parser.parse_args(argv)

    for f in dataclasses.fields(Config):
        v = getattr(args, f.name, None)
        if v is not None:
            cfg_kwargs[f.name] = v
    cfg = Config(**cfg_kwargs)
    if args.O_flag:  # reference -O: fp16 + cuda_ray + preload
        cfg.fp16 = True
        cfg.cuda_ray = True
        cfg.preload = True
    return cfg.validate()
