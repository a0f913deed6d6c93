"""Typed configuration, copied from ``deft_tpu/config.py``.

The PyTorch port keeps the same fields, defaults and derived-field rules as
the JAX package, so one ``Config`` describes a run of either package.  The
notes below are the JAX package's.

Replaces the reference's argparse-based ``opts`` class
(the reference DEFT's ``src/lib/opts.py:14-554``) with a plain dataclass.  The
derived-field rules (``parse()``: threshold maxima, head_conv defaults,
``update_dataset_info_and_set_heads()``: resolution + head dict + loss-weight
table) are reproduced as pure functions so that no configuration happens at
import time (the reference executes ``opts().parse()`` when ``tracker.py`` is
imported -- ``tracker.py:139`` -- which we deliberately do not replicate).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from deft_tpu_torch.data.datasets import get_dataset_info


@dataclass
class Config:
    # ---- task / experiment --------------------------------------------------
    task: str = "tracking"          # "tracking", "ddd", comma-combinable
    dataset: str = "mot"            # mot | kitti_tracking | nuscenes | coco | custom
    test_dataset: str = ""
    exp_id: str = "default"
    debug: int = 0
    seed: int = 317

    # ---- model --------------------------------------------------------------
    arch: str = "dla_34"
    dla_node: str = "dcn"           # dcn | conv | gcn  (reference dla.py:751-755)
    head_conv: int = -1             # -1 -> 256 for dla, 64 otherwise (opts.py:449)
    num_head_conv: int = 1
    head_kernel: int = 3
    down_ratio: int = 4
    num_classes: int = -1
    num_layers: int = 101
    backbone: str = "dla34"
    neck: str = "dlaup"
    msra_outchannel: int = 256
    prior_bias: float = -4.6
    input_h: int = -1
    input_w: int = -1
    dataset_version: str = ""

    # ---- training -----------------------------------------------------------
    save_all: bool = False
    optim: str = "adam"
    lr: float = 1.25e-4
    lr_step: Tuple[int, ...] = (60,)
    save_point: Tuple[int, ...] = (90,)
    num_epochs: int = 80
    batch_size: int = 4
    num_iters: int = -1
    val_intervals: int = 10000
    test: bool = False              # short-circuit train.py to evaluation
                                    # (reference train.py:68-71)
    momentum: float = 0.9           # SGD path (reference train.py:25-30)
    weight_decay: float = 1e-4

    # ---- box regression heads -----------------------------------------------
    ltrb: bool = False
    ltrb_weight: float = 0.1
    ltrb_amodal: bool = False
    ltrb_amodal_weight: float = 0.1
    reset_hm: bool = False
    reuse_hm: bool = False
    dense_reg: int = 1

    # ---- test ---------------------------------------------------------------
    flip_test: bool = False
    test_scales: Tuple[float, ...] = (1.0,)
    nms: bool = False
    K: int = 100
    fix_short: int = -1
    keep_res: bool = False
    out_thresh: float = -1.0
    depth_scale: float = 1.0
    save_results: bool = False
    load_results: str = ""
    use_loaded_results: bool = False
    test_focal_length: int = -1
    vis_thresh: float = 0.3
    profile: str = ""               # jax.profiler trace dir for test.py/bench
    eval_val: bool = False
    save_video: bool = False
    trainval: bool = False

    # ---- data augmentation --------------------------------------------------
    not_rand_crop: bool = False
    not_max_crop: bool = False
    shift: float = 0.0
    scale: float = 0.0
    aug_rot: float = 0.0
    rotate: float = 0.0
    flip: float = 0.5
    no_color_aug: bool = False

    # ---- tracking -----------------------------------------------------------
    tracking: bool = False
    pre_hm: bool = False
    pre_img: bool = False
    no_pre_img: bool = False
    same_aug_pre: bool = False
    zero_pre_hm: bool = False
    hm_disturb: float = 0.0
    lost_disturb: float = 0.0
    fp_disturb: float = 0.0
    pre_thresh: float = -1.0
    track_thresh: float = 0.3
    new_thresh: float = 0.3
    max_frame_dist: int = 1
    public_det: bool = False
    # Reference-parity embedding sampling: the reference normalizes AFE
    # sample centers by the ORIGINAL image dims although the feature maps
    # live in the warped input frame (utils/tracker.py:818, test.py:163-164).
    # Default (False) samples at the warped-input-frame centers -- where the
    # features actually are; True reproduces the reference quirk exactly for
    # bit-matched affinity comparisons.
    embed_parity: bool = False
    zero_tracking: bool = False
    hungarian: bool = False
    max_age: int = -1
    afe: bool = True                # reference --AFE (opts.py:337)
    max_frame_dist_afe: int = 10
    max_object: int = 100
    track_buffer: int = 30
    tracking_weight: float = 1.0
    lstm: bool = True               # forced off unless nuscenes (opts.py:478-479)
    load_model: str = ""
    load_model_traj: str = ""
    resume: bool = False

    # ---- losses -------------------------------------------------------------
    reg_loss: str = "l1"
    hm_weight: float = 1.0
    off_weight: float = 1.0
    wh_weight: float = 0.1
    hp_weight: float = 1.0
    hm_hp_weight: float = 1.0
    amodel_offset_weight: float = 1.0
    dep_weight: float = 1.0
    dim_weight: float = 1.0
    rot_weight: float = 1.0
    nuscenes_att: bool = False
    nuscenes_att_weight: float = 1.0
    velocity: bool = False
    velocity_weight: float = 1.0
    matching_weight: float = 1.0

    # ---- custom dataset -----------------------------------------------------
    custom_dataset_img_path: str = ""
    custom_dataset_ann_path: str = ""

    # ---- TPU / parallelism (new; replaces reference DataParallel machinery) --
    mesh_shape: Tuple[int, ...] = ()          # () -> all local devices on one axis
    mesh_axis_names: Tuple[str, ...] = ("data",)
    param_dtype: str = "float32"
    compute_dtype: str = "float32"            # bfloat16 for speed once validated
    # DCN lowering: "hybrid" (default) picks the fastest kernel per layer
    # shape: channel-major Pallas for C<=128 on TPU, onehot elsewhere
    # (whole-model dla34-dcn forward on v5e bf16 544x960: onehot 30.6 ->
    # hybrid 28.1 ms/frame; per-layer table in ops/pallas_dcn.py docstring)
    # | "onehot" (bilinear gather as a batched one-hot MXU
    # matmul -- fastest measured on v5e, exact for offsets within
    # +-dcn_offset_range) | "gather" (per-pixel XLA gather, exact for ANY
    # offset) | "shift" | "pallas".  Whole-model frame_step on v5e bf16:
    # onehot 1.57 ms/frame vs gather 2.05 vs shift 2.22.
    dcn_impl: str = "hybrid"
    # offset clamp for the non-gather impls; trained DEFT offsets concentrate
    # well inside +-4 px, and the clamp sets the onehot/shift kernels' halo
    # size and unrolled-shift count (compile + run time grow with it)
    dcn_offset_range: int = 4
    # per-layer radius overrides as a JSON object mapping a substring of the
    # DCN layer's module path (e.g. "ida_0/node_1") to its clamp radius;
    # layers not matched keep dcn_offset_range.  Produce the value with
    # tools/measure_dcn_offsets.py (it prints the exact per-layer radii of a
    # trained checkpoint); the pallas/onehot kernels' work scales with
    # (2r+5)^2 resp. (2r+1), so shrinking quiet layers is pure speed.
    dcn_layer_radii: str = ""
    sims_quant: bool = False                  # uint8 similarity transfer
    # upload per-frame uint8 DELTAS against the previous warped frame and
    # reconstruct on device (wraparound arithmetic -- bit-exact).  Wins when
    # the host<->device transport compresses (remote-attached tunnels);
    # neutral-to-negative on local PCIe.  fix_res inputs only.
    delta_upload: bool = False
    # upload frames as planar YUV 4:2:0 ([H*3/2, W] uint8 -- HALF the bytes
    # of [H, W, 3]): the host packs BT.601 full-range with 2x2-averaged
    # chroma, the device decodes + normalizes in the fused frame program.
    # LOSSY in chroma detail: natural video sources (H.264 yuv420p) never
    # carried it, but on the saturated-color 96x160 synthetic benchmark the
    # measured cost is ~5 MOTA (76.7 -> 71.3, 0 IDS both) -- use for
    # bandwidth-starved transports with natural video only, never as the
    # default.  fix_res inputs only; mutually exclusive with delta_upload.
    yuv_upload: bool = False
    # similarity window actually evaluated/downloaded per frame: -1 = auto
    # (freshness_window(dataset) + 2 -- frames beyond it carry temporal decay
    # <= 0.01^((F+1)/3) ~ 0, tracker.py:76-90), 0 = the full 50-slot ring
    sim_window: int = -1
    # chunked dispatch (runner chunk > 1): batch the model forward over the
    # chunk and scan only the ring-similarity tail (frame_chunk_batched) vs
    # scanning the whole frame program (frame_chunk).  Output-identical;
    # per-shape perf differs (batched routes DCN through onehot).
    chunk_batched: bool = False
    # chunked dispatch staging: stack the chunk's warped frames into ONE
    # host buffer shipped as a single device_put on a dedicated chain
    # worker (upload -> dispatch -> fetch-submit), so the main thread keeps
    # warping the next chunk during the wire time and the chunk pays one
    # relay transfer instead of one per frame (measured round 4: 1.57 MB at
    # ~21 MB/s forced-resident vs 6.2 MB at ~34 MB/s -- bulk transfers ride
    # the relay better).  Bit-exact vs per-frame staging (same bytes; the
    # stack just happens on host).  Set False to restore per-frame staging
    # (starts each frame's upload the moment it is warped -- lower
    # single-stream latency, more relay round trips).
    # PipelinedRunner.auto_tune() measures both on real frames and picks.
    stacked_upload: bool = True
    # warp the input affine ON DEVICE (ops/warp.py: two MXU matmuls from the
    # separable rot=0 transform) instead of host cv2.warpAffine: the host
    # ships the RAW uint8 frame + 6 coefficients.  Kills the ~5 ms/frame
    # main-thread warp but uploads full-resolution bytes (1080p: 6.2 MB vs
    # 1.6 MB warped) -- a clear win on locally-attached TPUs (PCIe GB/s),
    # a loss through bandwidth-starved relays.  fix_res inputs only;
    # exclusive with delta/yuv uploads and public_det.
    device_warp: bool = False
    align_corners: bool = True                # torch-1.2 grid_sample semantics

    # ---- derived (filled by finalize / wire_dataset) --------------------------
    heads: Dict[str, int] = field(default_factory=dict)
    weights: Dict[str, float] = field(default_factory=dict)
    head_convs: Dict[str, List[int]] = field(default_factory=dict)
    output_h: int = -1
    output_w: int = -1
    input_res: int = -1
    output_res: int = -1
    num_stacks: int = 1
    pad: int = 31
    save_dir: str = "exp"

    # ------------------------------------------------------------------------

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def finalize(cfg: Config) -> Config:
    """Derived-field rules of the reference ``opts.parse()`` (opts.py:409-482)."""
    updates: Dict[str, object] = {}
    if len(cfg.test_scales) == 0:
        raise ValueError("test_scales needs at least one value")
    if len(cfg.test_scales) > 1:
        # parity with the reference, which asserts this in merge_outputs
        # (detector.py:578: "multi_scale not supported!")
        raise ValueError("multi-scale test_scales not supported")
    if cfg.test_dataset == "":
        updates["test_dataset"] = cfg.dataset
    if "tracking" in cfg.task:
        updates["tracking"] = True
        updates["out_thresh"] = max(cfg.track_thresh, cfg.out_thresh)
        updates["pre_thresh"] = max(cfg.track_thresh, cfg.pre_thresh)
        updates["new_thresh"] = max(cfg.track_thresh, cfg.new_thresh)
        updates["pre_img"] = not cfg.no_pre_img
    if cfg.head_conv == -1:
        updates["head_conv"] = 256 if "dla" in cfg.arch else 64
    updates["pad"] = 127 if "hourglass" in cfg.arch else 31
    updates["num_stacks"] = 2 if cfg.arch == "hourglass" else 1
    if cfg.dataset != "nuscenes":
        updates["lstm"] = False
    return cfg.replace(**updates)


# Default head-channel contract (opts.py:485-543). ``dataset_info`` must expose
# ``num_categories`` and ``default_resolution`` (h, w); the dataset classes in
# deft_tpu_torch.data.datasets satisfy this.
def wire_dataset(cfg: Config, dataset_info) -> Config:
    num_classes = (
        dataset_info.num_categories if cfg.num_classes < 0 else cfg.num_classes
    )
    input_h, input_w = dataset_info.default_resolution
    input_h = cfg.input_h if cfg.input_h > 0 else input_h
    input_w = cfg.input_w if cfg.input_w > 0 else input_w
    output_h = input_h // cfg.down_ratio
    output_w = input_w // cfg.down_ratio

    heads: Dict[str, int] = {"hm": num_classes, "reg": 2, "wh": 2}
    if "tracking" in cfg.task:
        heads["tracking"] = 2
    if "ddd" in cfg.task:
        heads.update({"dep": 1, "rot": 8, "dim": 3, "amodel_offset": 2})
    if cfg.ltrb:
        heads["ltrb"] = 4
    if cfg.ltrb_amodal:
        heads["ltrb_amodal"] = 4
    if cfg.nuscenes_att:
        heads["nuscenes_att"] = 8
    if cfg.velocity:
        heads["velocity"] = 3

    weight_table = {
        "hm": cfg.hm_weight,
        "wh": cfg.wh_weight,
        "reg": cfg.off_weight,
        "dep": cfg.dep_weight,
        "rot": cfg.rot_weight,
        "dim": cfg.dim_weight,
        "amodel_offset": cfg.amodel_offset_weight,
        "ltrb": cfg.ltrb_weight,
        "tracking": cfg.tracking_weight,
        "ltrb_amodal": cfg.ltrb_amodal_weight,
        "nuscenes_att": cfg.nuscenes_att_weight,
        "velocity": cfg.velocity_weight,
    }
    weights = {h: weight_table[h] for h in heads}
    heads = {h: c for h, c in heads.items() if weights[h] != 0}
    weights = {h: w for h, w in weights.items() if h in heads}

    head_conv = cfg.head_conv if cfg.head_conv > 0 else (256 if "dla" in cfg.arch else 64)
    head_convs = {
        h: [head_conv] * (cfg.num_head_conv if h != "reg" else 1) for h in heads
    }

    return cfg.replace(
        num_classes=num_classes,
        input_h=input_h,
        input_w=input_w,
        output_h=output_h,
        output_w=output_w,
        input_res=max(input_h, input_w),
        output_res=max(output_h, output_w),
        heads=heads,
        weights=weights,
        head_convs=head_convs,
    )


def mot_config(**kw) -> Config:
    """MOT17 tracking config matching experiments/mot17_tracking.sh defaults."""
    base = dict(
        task="tracking", dataset="mot", ltrb_amodal=True,
        track_thresh=0.4, pre_hm=False, shift=0.05, scale=0.05,
        hm_disturb=0.05, lost_disturb=0.4, fp_disturb=0.1,
    )
    base.update(kw)
    cfg = finalize(Config(**base))
    return wire_dataset(cfg, get_dataset_info(cfg.dataset))


def kitti_config(**kw) -> Config:
    base = dict(task="tracking", dataset="kitti_tracking", track_thresh=0.4)
    base.update(kw)
    cfg = finalize(Config(**base))
    return wire_dataset(cfg, get_dataset_info(cfg.dataset))


def nuscenes_config(**kw) -> Config:
    base = dict(
        task="tracking,ddd", dataset="nuscenes", nuscenes_att=True, velocity=True,
        track_thresh=0.1,
    )
    base.update(kw)
    cfg = finalize(Config(**base))
    return wire_dataset(cfg, get_dataset_info(cfg.dataset))
