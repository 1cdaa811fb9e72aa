"""Typed configuration for TextSLAM (PyTorch port).

A copy of `textslam_tpu/config.py`: importing that module would import the
JAX package (its `__init__` imports jax), so the port carries its own copy
of the same dataclasses. Keep the two in step.

The reference scatters constants across the code (see SURVEY.md §5-config:
ORB counts at src/tracking.cc:29-33, pyramid at :35-36, KF policy at :50-51,
match thresholds at :21-23, BA weights/chi2 in src/optimizer.cc, per-experiment
loop thresholds in src/loopClosing.cc:25-42, camera yaml in src/setting.cc:33-89).
Here every tunable lives in one frozen dataclass so jitted code can close over
static values and experiments stay reproducible.
"""

from __future__ import annotations

import dataclasses
import enum
import math
import os
from typing import Tuple


class Experiment(enum.IntEnum):
    """Experiment ids (reference: src/setting.h:238-243)."""

    GENERAL_MOTION = 0
    INDOOR_LOOP_A = 1  # small indoor loop
    INDOOR_LOOP_L = 2  # large indoor loop
    OUTDOOR = 3


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole intrinsics + radial-tangential distortion (src/setting.cc:44-79)."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 640
    height: int = 480
    fps: float = 30.0
    rgb: bool = True

    @property
    def K(self):
        import numpy as np

        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float64,
        )

    @property
    def dist(self):
        import numpy as np

        return np.array([self.k1, self.k2, self.p1, self.p2, self.k3], dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class PyramidConfig:
    """Image pyramid for direct text alignment (src/tracking.cc:35-36: 8 levels, x2)."""

    levels: int = 8
    scale: float = 2.0
    # levels actually used by the optimizers (src/optimizer.cc: PyrIniBA uses 3..0,
    # PoseOptim/LocalBA/ThetaOptim use 2..0, Landmarkers uses 3..0)
    init_ba_levels: Tuple[int, ...] = (3, 2, 1, 0)
    pose_levels: Tuple[int, ...] = (2, 1, 0)
    ba_levels: Tuple[int, ...] = (2, 1, 0)
    landmark_levels: Tuple[int, ...] = (3, 2, 1, 0)
    theta_levels: Tuple[int, ...] = (2, 1, 0)


@dataclasses.dataclass(frozen=True)
class ORBConfig:
    """ORB feature extraction (src/tracking.cc:29-39, src/ORBextractor.cc)."""

    n_features: int = 1000
    n_features_init: int = 3000  # bootstrap extractor uses 3000 features
    scale_factor: float = 1.2
    n_levels: int = 8
    # The reference's per-cell FAST runs at threshold 20 with a 7 fallback
    # (src/ORBextractor.cc:810-816). The dense score-map design here detects
    # at the LOW threshold everywhere and lets per-cell top-k keep the
    # strongest corners, which subsumes the two-pass fallback — so only the
    # low threshold is a tunable. The BRIEF patch geometry (31x31 patch,
    # radius-15 IC_Angle disc, 19px border) is structural to the descriptor
    # and lives as constants in ops/orb.py (PATCH/HALF_PATCH), not config.
    fast_threshold_min: int = 7
    # capacity of the padded keypoint pools (per frame, all levels fused)
    max_keypoints: int = 4096
    # per-frame in-text-box densification budget (the reference's second ORB
    # pass per box, FeatExtracText src/frame.cc:232,334; 0 disables) and the
    # boundary prune margin in px (BoundFeatDele_T WinText = -3,
    # src/frame.cc:241)
    n_box_features: int = 256
    box_boundary_margin: float = 3.0


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Descriptor matching thresholds (src/tracking.cc:21-23, :1045-1273)."""

    th_low: int = 50
    th_high: int = 100
    # rotation-consistency histogram bins. NOTE: in the reference this is
    # vestigial ORB-SLAM code — HISTO_LENGTH (src/tracking.cc:23) and
    # ComputeThreeMaxima (:2780) are defined but called by NO matcher
    # (verified by grep over src/ + include/). The filter is therefore
    # opt-in here: use_rotation_check=False reproduces reference behavior;
    # True applies ops.matching.rotation_histogram_filter (keep the 3 most
    # populated of `histo_length` bins) in the init + triangulation matchers.
    histo_length: int = 30
    use_rotation_check: bool = False
    nn_ratio_init: float = 0.9
    search_radius_3d: float = 18.0  # px window for SearchFrom3D
    search_window_init: float = 100.0  # two-view bootstrap window
    search_window_triangulate: float = 80.0  # SearchForTriangular (x1.2 per octave)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """LM/BA constants (src/optimizer.cc; SURVEY.md §2.3)."""

    weight_scene: float = 1.0 / 1.2  # px sigma^-1  (src/optimizer.cc:1087)
    weight_text: float = 1.0 / 0.2  # normalized-intensity sigma^-1 (:1088)
    huber_scene_init: float = 3.0
    huber_scene_pose: float = math.sqrt(5.991)
    huber_text: float = 3.0
    huber_rho: float = math.sqrt(5.991)
    huber_theta: float = 2.0
    huber_sim3: float = math.sqrt(10.0)
    chi2_mono_pose: float = 12.25
    chi2_mono_pose_lowtext: float = 16.25  # +4 when <50 text residuals (:1238-1257)
    chi2_mono_global: float = 18.0
    chi2_text_levels: Tuple[float, ...] = (0.95, 0.5, 0.5, 0.5)  # level 0..3 gates
    chi2_text_landmark: float = 1.5
    # PyrLandmarkers has the text gate coded but hard-disabled
    # (TEXTOutlier=false, src/optimizer.cc:1861); flip this to enable it
    text_outlier_landmark: bool = False
    # reference PyrIniBA optimizes pose+rho+theta JOINTLY
    # (src/optimizer.cc:1030); default False = scene-only init BA + separate
    # fixed-pose theta refinement (measured better on rendered GT — see
    # PARITY.md "Known deviations" and the multi-seed A/B in PROGRESS.md)
    joint_init_ba: bool = False
    # a text observation (KF, object) goes bad when more than this fraction
    # of its features fail the per-sample gate (TextRatio,
    # src/optimizer.cc:1082,1291)
    text_bad_ratio: float = 0.99
    iters_per_level: int = 10
    iters_landmark: int = 50
    iters_sim3: int = 20
    iters_pose_graph: int = 20
    ba_window: int = 20  # sliding window KF count (src/tracking.cc:828-842)
    # per-KF residual budget for text PAIRS in the windowed BA (a pair =
    # one (window KF, GOOD object) photometric observation block of F
    # rows): text-dense maps otherwise grow the padded pair tier — and the
    # whole fused-BA program — linearly in the live-object count. Budget
    # keeps the longest-observed objects' pairs; drops are LOGGED
    # (SURVEY "no silent caps"). 0 disables.
    max_text_pairs_ba: int = 384
    # loop-time OptimizeLandmarker above this many KFs decomposes into the
    # rho-only solve (no-free-poses fast path) + the chunked per-object
    # theta pass (TextFrontend.landmark_theta_pass) instead of one joint
    # solve stacking ALL window-KF images (1.9 GB at K=512 level 0 —
    # VERDICT r4 weak #1); below it the joint path is kept (it reproduces
    # the reference's single-problem LM schedule exactly)
    global_decompose_kfs: int = 64
    # image-residency bound for one landmark-theta chunk: the union of a
    # chunk's observing-KF level images stays at or under this many frames
    landmark_chunk_kfs: int = 24
    # LM damping schedule
    lm_lambda_init: float = 1e-4
    lm_lambda_up: float = 10.0
    lm_lambda_down: float = 0.1
    lm_max_lambda: float = 1e8
    lm_min_lambda: float = 1e-12


@dataclasses.dataclass(frozen=True)
class TextConfig:
    """Text-object pipeline (src/tracking.cc, src/mapText.cc)."""

    neighbour_pattern: int = 8  # INTERVAL8 (src/tool.cc:1540-1568)
    zncc_min: float = 0.1  # TextJudge gate (src/tracking.cc:1966-1988)
    cos_orientation_min: float = 0.5  # CheckOrientation (src/tool.cc:1393-1407)
    cos_promote: float = 0.9  # IMMATURE->GOOD theta stability (src/tracking.cc:1920-1962)
    # promotion needs NumObvs >= 4 FRAME observations (TextUpdate runs every
    # frame and bumps NumObvs per observable frame, src/tracking.cc:1934,1951)
    min_obs_promote: int = 4
    in_image_margin: float = 6.0  # box projection must be in-image +-6px
    # semantic demotion thresholds {2, 0.9, 40}: keep GOOD only while
    # good > 2 AND good*0.9 > bad AND bad < 40, once the map has > 5 KFs and
    # the host KF is at least 5 KFs old (src/tracking.cc:2307-2340, :2421-2433)
    sem_min_good: int = 2
    sem_bad_ratio: float = 0.9
    sem_max_bad: int = 40
    sem_kf_age: int = 5
    # semantic meaning fusion: S_semantic = S_geo + S_mean, argmin wins;
    # S_mean = (1 - score)*200, S_geo = (1 + cos)*10 + d
    # (UpdateSemantic_MapObjs_single + GetSgeo, src/tracking.cc:2362-2527)
    sem_weight_mean: float = 200.0
    sem_weight_view: float = 10.0
    # per-frame IMMATURE maturation budget: at most this many visible
    # IMMATURE objects refine per frame, round-robin across frames so every
    # object still matures (NumObvs accumulates whenever processed; the
    # reference's serial TextUpdate has the same linear-in-immature-count
    # frame cost and its sequences never reach hundreds of immature
    # objects). Logged when it binds; 0 disables. PARITY.md documents the
    # deviation.
    immature_budget_per_frame: int = 48
    # per-frame IMMATURE maturation (ThetaOptimMultiFs at frame cadence)
    # keeps at most this many observing KFs + the current frame per object;
    # the reference optimizes over ALL observing KFs
    # (src/optimizer.cc:565-624) — a DOCUMENTED deviation (PARITY.md):
    # the cap bounds the per-frame image residency and is logged when it
    # binds. 0 = unlimited (exact reference semantics). IMMATURE objects
    # promote at 4 observations, so the cap binds only for long-immature
    # stragglers; the loop-time landmark pass (landmark_theta_pass) always
    # uses all observing KFs.
    theta_kf_cap: int = 8
    # padded capacities
    max_objects: int = 512
    max_features_per_level: int = 64  # direct features per object per pyramid level
    max_box_pixels: int = 4096  # level-0 in-box pixels for ZNCC
    max_detections_per_frame: int = 64


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Loop closing (src/loopClosing.cc:25-42, SURVEY.md §3.5)."""

    min_kfs_before_loop: int = 20
    min_kfs_between_loops: int = 20
    score_thresh_indoor: float = 0.51  # ScoreThresh_min indoor
    score_thresh_outdoor: float = 0.35  # ScoreThresh_min outdoor
    min_str_score: float = 0.3  # thMinStrScore (src/loopClosing.cc:122)
    top_candidates: int = 10  # TopN (src/loopClosing.cc:282)
    num_covis_for_thresh: int = 10  # num_neighKFs in GetThreshWordsNum (:601)
    thresh_words_scale: float = 0.6  # floor(0.6 * thresh) (:78)
    min_inliers: int = 25  # accept requires MaxInlierNum > 25 (:93-106)
    # Thmin_ThreshMatchWordsNum (:27-34): indoor 1 / outdoor 2
    thmin_match_words_indoor: int = 1
    thmin_match_words_outdoor: int = 2
    # Th_nInliers_Scene (:28-41): candidate-selection scene-inlier gate,
    # active only for INDOOR_LOOP_A (8); -1 disables
    th_inliers_scene_indoor_a: int = 8
    # Th_MaxInlierNum_S (:29): final-accept scene-inlier gate, outdoor only
    min_scene_inliers_outdoor: int = 10
    # DoubleCheck_Visible (:31): vConnects 2-hop exclusion, outdoor only
    double_check_visible_outdoor: bool = True
    sim3_ransac_iters: int = 200
    sim3_min_inliers: int = 20  # Sim3Solver SetRansacParameters(0.99, 20, 300)
    sim3_inlier_err2: float = 45.0  # px^2 symmetric reprojection (Sim3Solver.cc:195-221)
    sim3_refine_err: float = 4.0  # px after Ceres-style refine (src/optimizer.cc:706-729)
    # SearchAndFuse projection window (the reference searches a fixed-radius
    # neighbourhood around each projected loop landmark,
    # src/loopClosing.cc:1045-1385) and a fusion budget per loop closure —
    # the budget is a safety valve against a degenerate Sim3 fusing the whole
    # map; hitting it is LOGGED, never silent
    fuse_radius_px: float = 5.0
    max_fusions_per_loop: int = 2000
    # DetectLoop string-length handling: the device Levenshtein pads all
    # strings to a power-of-two tier sized from the ACTUAL length
    # distribution per call; calls whose longest string exceeds this cap
    # route through the native arbitrary-length path instead (the reference
    # scores full strings, src/loopClosing.cc:190-193 / src/tool.cc:264-299
    # — no truncation anywhere)
    lev_device_max_len: int = 64


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh scale-out (SURVEY.md §2.4; no reference analog — the
    reference is single-threaded, src/optimizer.cc:1600 num_threads=1)."""

    # devices for windowed/global BA: 0 or 1 = single-device solve_ba;
    # >1 = Tracker._local_ba dispatches to parallel.ba_sharded.solve_ba_sharded
    # over a mesh of this many devices (parallel.mesh.make_mesh: capped to
    # the CUDA device count; on the CPU, this many shards).
    ba_devices: int = 0
    # devices for the covisibility rebuild products (SURVEY.md §2.4 "map
    # sharding"): >1 = SlamMap.rebuild_covis_m1/m23 run the keyframe-axis-
    # sharded float32 matmul (parallel.covis_sharded) once the map has at
    # least covis_min_kfs keyframes, below that the host product.
    # covis_min_kfs is the JAX package's default, its crossover on a TPU;
    # the H100's own is measured by chip_smoke.py phase 9 (PERF.md)
    covis_devices: int = 0
    covis_min_kfs: int = 384


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Map capacities (padded SoA pools; reference sizes covis to
    ceil(numImages/ceil(fps/3)), src/system.cc:23-29).

    The defaults suit the test/benchmark harness; real runs derive the
    caps from the dataset length via `MapConfig.derive` (main.py does) —
    the reference's own param_M rule — so a pool can only saturate if the
    keyframe cadence exceeds the reference's design envelope, and
    saturation is graceful (logged drop, never an exception;
    SlamMap._saturate)."""

    max_keyframes: int = 512
    max_points: int = 32768
    max_texts: int = 512
    max_obs_per_kf: int = 2048
    local_map_kf_cap: int = 80  # src/tracking.cc:738

    @staticmethod
    def derive(num_images: int, fps: float,
               base: "MapConfig" = None) -> "MapConfig":
        """Size the pools from the image-list length like the reference:
        param_M = ceil(numImages / ceil(fps/3)) keyframes
        (src/system.cc:23-29), +25% headroom because the c2 condition can
        insert faster than the fps/3 cadence; point/text pools scale with
        the keyframe budget."""
        base = base or MapConfig()
        param_m = math.ceil(num_images / max(1, math.ceil(fps / 3.0)))
        kf = max(64, int(param_m * 1.25))
        return dataclasses.replace(
            base,
            max_keyframes=kf,
            max_points=max(8192, 128 * kf),
            max_texts=max(128, min(8192, 8 * kf)),
        )


@dataclasses.dataclass(frozen=True)
class TextSLAMConfig:
    experiment: Experiment = Experiment.GENERAL_MOTION
    no_text: bool = False  # `Exp noText` ablation (src/setting.h:246)
    read_path: str = ""
    read_list: str = "Imlist.txt"
    camera: CameraConfig = dataclasses.field(
        default_factory=lambda: CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
    )
    pyramid: PyramidConfig = dataclasses.field(default_factory=PyramidConfig)
    orb: ORBConfig = dataclasses.field(default_factory=ORBConfig)
    match: MatchConfig = dataclasses.field(default_factory=MatchConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    loop: LoopConfig = dataclasses.field(default_factory=LoopConfig)
    map: MapConfig = dataclasses.field(default_factory=MapConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    seed: int = 0  # deterministic runs (reference: srand(0), SeedRandOnce(0))

    @property
    def loop_score_thresh(self) -> float:
        if self.experiment == Experiment.OUTDOOR:
            return self.loop.score_thresh_outdoor
        return self.loop.score_thresh_indoor

    @property
    def loop_thmin_match_words(self) -> int:
        """Per-experiment Thmin_ThreshMatchWordsNum (src/loopClosing.cc:27,34)."""
        if self.experiment == Experiment.OUTDOOR:
            return self.loop.thmin_match_words_outdoor
        return self.loop.thmin_match_words_indoor

    @property
    def loop_th_inliers_scene(self) -> int:
        """Per-experiment Th_nInliers_Scene (src/loopClosing.cc:28,39-41):
        8 for INDOOR_LOOP_A, disabled (-1) otherwise."""
        if self.experiment == Experiment.INDOOR_LOOP_A:
            return self.loop.th_inliers_scene_indoor_a
        return -1

    @property
    def loop_th_max_inlier_scene(self) -> int:
        """Per-experiment Th_MaxInlierNum_S (src/loopClosing.cc:29): final-
        accept scene-inlier requirement, outdoor only; -1 disables."""
        if self.experiment == Experiment.OUTDOOR:
            return self.loop.min_scene_inliers_outdoor
        return -1

    @property
    def loop_double_check_visible(self) -> bool:
        """DoubleCheck_Visible (src/loopClosing.cc:31): outdoor only."""
        return (self.experiment == Experiment.OUTDOOR
                and self.loop.double_check_visible_outdoor)

    @property
    def kf_min_gap(self) -> int:
        """KF policy gap = fps/2 frames (mMaxFrames, src/tracking.cc:50,886)."""
        return int(self.camera.fps // 2)

    @property
    def kf_max_gap(self) -> int:
        """Forced-KF gap = fps/2 + 5 frames (mMaxFramesMax feeding the c3
        condition, src/tracking.cc:51,888)."""
        return self.kf_min_gap + 5


def _parse_filestorage(path: str) -> dict:
    """The top-level scalars of an OpenCV FileStorage YAML file (the subset
    the reference's experiment files use): `key: value` lines, keys may hold
    spaces (`Exp read path`), values are double- or single-quoted strings
    (no escapes), ints, floats (`1e-3`) or bare strings; `#` starts a
    comment outside quotes; an optional `%YAML:1.0` directive and `---` start the file.
    Numbers come back as int / float, strings as str. Anything else (nested
    maps, sequences, matrices) raises ValueError naming the file and line."""
    import re

    out = {}
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    for n, line in enumerate(lines, 1):
        body = line.strip()
        if not body or body.startswith("#") or (n == 1 and body.startswith("%YAML")) \
                or body == "---":
            continue
        key, sep, rest = line.partition(":")
        if not sep or line[0].isspace() or not key.strip():
            raise ValueError(f"{path}:{n}: not a top-level `key: value` line: {line!r}")
        rest = rest.strip()
        if rest[:1] in ('"', "'"):
            m = re.match(r'"([^"]*)"' if rest[0] == '"' else r"'([^']*)'", rest)
            if m is None:
                raise ValueError(f"{path}:{n}: unterminated string: {line!r}")
            tail = rest[m.end():].strip()
            if tail and not tail.startswith("#"):
                raise ValueError(f"{path}:{n}: text after a quoted string: {line!r}")
            val = m.group(1)
        else:
            val = rest.split("#", 1)[0].strip()
            if val[:1] in ("{", "[", "!", "|", ">") or not val:
                raise ValueError(f"{path}:{n}: only scalar values are supported: {line!r}")
            for conv in (int, float):
                try:
                    val = conv(val)
                    break
                except ValueError:
                    pass
        out[key.strip()] = val
    return out


def load_yaml(path: str) -> TextSLAMConfig:
    """Load a reference-style experiment yaml (src/setting.cc:33-89).

    The reference yaml is an OpenCV FileStorage file with keys
    `Exp name/noText/read path/read list`, `Camera.fx/.fy/...`, read here by
    a parser of its scalar subset (no OpenCV). A missing key takes the
    default below; a number where a string is expected is read as its text,
    a string where a number is expected raises ValueError.
    """
    if not os.path.isfile(path):
        raise FileNotFoundError(f"cannot open yaml config: {path}")
    fs = _parse_filestorage(path)

    def fnode(name, default=0.0):
        v = fs.get(name, default)
        if isinstance(v, str):
            raise ValueError(f"{path}: {name!r} must be a number, got {v!r}")
        return float(v)

    def snode(name, default=""):
        return str(fs.get(name, default))

    cam = CameraConfig(
        fx=fnode("Camera.fx"),
        fy=fnode("Camera.fy"),
        cx=fnode("Camera.cx"),
        cy=fnode("Camera.cy"),
        k1=fnode("Camera.k1"),
        k2=fnode("Camera.k2"),
        p1=fnode("Camera.p1"),
        p2=fnode("Camera.p2"),
        k3=fnode("Camera.k3"),
        width=int(fnode("Camera.width", 640)),
        height=int(fnode("Camera.height", 480)),
        fps=fnode("Camera.fps", 30.0),
        rgb=bool(int(fnode("Camera.RGB", 1))),
    )
    # the reference composes the list path as read_path + read_list + ".txt"
    # (src/setting.cc:62: sReadPath_ImgList = sReadPath+Imagelist_name+".txt")
    # — the yaml value is a NAME without extension; a value that already
    # carries .txt is accepted as-is for convenience
    read_list = snode("Exp read list", "Imlist")
    if not read_list.endswith(".txt"):
        read_list = read_list + ".txt"
    return TextSLAMConfig(
        experiment=Experiment(int(fnode("Exp name", 0))),
        no_text=bool(int(fnode("Exp noText", 0))),
        read_path=snode("Exp read path"),
        read_list=read_list,
        camera=cam,
    )
