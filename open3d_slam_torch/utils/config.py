"""Parameter tree + layered config loading.

Python mirror of the reference's ``Parameters.hpp`` struct tree
(``include/open3d_slam/Parameters.hpp:51-205``) and of its layered
Lua config semantics (defaults + per-sensor override files, with
unused/duplicate key linting — ``LuaLoader.cpp:173-192, 201-223``).

Config files are YAML (or JSON) dictionaries whose nesting mirrors the
dataclass tree; an override file is applied on top of the defaults.  Keys
that do not correspond to any dataclass field raise (the reference warns on
unloaded keys; we are stricter).

One addition over the reference: ``CapacityParameters`` — XLA requires
static shapes, so per-stage array capacities are explicit configuration.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


def config_path(name: str) -> str:
    """Absolute path of a packaged config file (the analog of the
    reference's ``param/`` folder).  Search order:
      1. ``$O3D_SLAM_CONFIG_DIR`` (explicit override / installed layouts),
      2. ``open3d_slam_torch/configs/`` (package data, if shipped),
      3. ``<repo>/configs/`` (source checkout).
    Returns the source-checkout path even if absent so callers get a clear
    FileNotFoundError naming the expected location."""
    env = os.environ.get("O3D_SLAM_CONFIG_DIR")
    if env:
        return os.path.join(env, name)
    here = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.normpath(os.path.join(here, "..", "configs", name))
    if os.path.exists(pkg):
        return pkg
    return os.path.normpath(os.path.join(here, "..", "..", "configs", name))

DEG2RAD = math.pi / 180.0

# ---------------------------------------------------------------------------
# Parameter dataclasses (mirroring Parameters.hpp field-for-field; trailing
# underscores dropped, camelCase -> snake_case).
# ---------------------------------------------------------------------------


@dataclass
class ScanCroppingParameters:  # Parameters.hpp:51-57
    cropping_min_z: float = -10.0
    cropping_max_z: float = 10.0
    cropping_min_radius: float = 0.0
    cropping_max_radius: float = 20.0
    cropper_name: str = "MaxRadius"


@dataclass
class ScanProcessingParameters:  # Parameters.hpp:59-64
    down_sampling_ratio: float = 1.0
    voxel_size: float = 0.03
    point_cloud_buffer_size: int = 1
    cropper: ScanCroppingParameters = field(default_factory=ScanCroppingParameters)


@dataclass
class IcpParameters:  # Parameters.hpp:66-71
    max_num_iter: int = 50
    max_correspondence_distance: float = 0.2
    knn: int = 5
    max_distance_knn: float = 10.0


@dataclass
class CloudRegistrationParameters:  # Parameters.hpp:73-76
    reg_type: str = "PointToPlaneIcp"  # PointToPlaneIcp|PointToPointIcp|GeneralizedIcp
    icp: IcpParameters = field(default_factory=IcpParameters)


@dataclass
class OdometryParameters:  # Parameters.hpp:78-83
    scan_matcher: CloudRegistrationParameters = field(default_factory=CloudRegistrationParameters)
    scan_processing: ScanProcessingParameters = field(default_factory=ScanProcessingParameters)
    is_publish_odometry_msgs: bool = False
    odometry_buffer_size: int = 1


@dataclass
class SpaceCarvingParameters:  # Parameters.hpp:85-92
    voxel_size: float = 0.1
    max_raytracing_length: float = 20.0
    truncation_distance: float = 0.1
    carve_space_every_n_scans: int = 10
    min_dot_product_with_normal: float = 0.5
    neighborhood_radius_dense_map: float = 0.1


@dataclass
class MapBuilderParameters:  # Parameters.hpp:94-98
    map_voxel_size: float = 0.03
    cropper: ScanCroppingParameters = field(default_factory=lambda: ScanCroppingParameters(
        cropping_max_radius=30.0))
    carving: SpaceCarvingParameters = field(default_factory=SpaceCarvingParameters)


@dataclass
class SubmapParameters:  # Parameters.hpp:100-106
    radius: float = 20.0
    min_num_range_data: int = 5
    min_seconds_between_feature_computation: float = 5.0
    adjacency_based_revisiting_min_fitness: float = 0.4
    num_scans_overlap: int = 3


@dataclass
class PlaceRecognitionConsistencyCheckParameters:  # Parameters.hpp:108-115
    max_drift_roll: float = 90.0 * DEG2RAD
    max_drift_pitch: float = 90.0 * DEG2RAD
    max_drift_yaw: float = 90.0 * DEG2RAD
    max_drift_z: float = 15.0
    max_drift_y: float = 10.0
    max_drift_x: float = 10.0


@dataclass
class PlaceRecognitionParameters:  # Parameters.hpp:117-136
    normal_estimation_radius: float = 1.0
    feature_voxel_size: float = 0.5
    feature_radius: float = 2.5
    feature_knn: int = 100
    normal_knn: int = 10
    ransac_num_iter: int = 1_000_000
    ransac_probability: float = 0.99
    ransac_model_size: int = 3
    ransac_max_correspondence_distance: float = 0.75
    correspondence_checker_distance: float = 0.75
    correspondence_checker_edge_length: float = 0.5
    ransac_min_correspondence_set_size: int = 25
    max_icp_correspondence_distance: float = 0.3
    min_refinement_fitness: float = 0.7
    is_dump_place_recognition_alignments_to_file: bool = False
    consistency_check: PlaceRecognitionConsistencyCheckParameters = field(
        default_factory=PlaceRecognitionConsistencyCheckParameters)
    min_submaps_between_loop_closures: int = 2
    loop_closure_search_radius: float = 20.0


@dataclass
class GlobalOptimizationParameters:  # Parameters.hpp:138-143
    max_correspondence_distance: float = 10.0
    loop_closure_preference: float = 2.0
    edge_prune_threshold: float = 0.2
    reference_node: int = 0


@dataclass
class ScanToMapRegistrationParameters:  # Parameters.hpp:145-149
    scan_to_map_reg_type: str = "PointToPlaneIcp"
    min_refinement_fitness: float = 0.7
    icp: IcpParameters = field(default_factory=IcpParameters)


@dataclass
class MapInitializingParameters:  # Parameters.hpp:151-156
    frame_id: str = ""
    initial_pose_xyz: tuple = (0.0, 0.0, 0.0)
    initial_pose_rpy_deg: tuple = (0.0, 0.0, 0.0)
    pcd_file_path: str = ""
    is_initialize_interactively: bool = False


@dataclass
class MapperParameters:  # Parameters.hpp:158-178
    scan_matcher: ScanToMapRegistrationParameters = field(default_factory=ScanToMapRegistrationParameters)
    scan_processing: ScanProcessingParameters = field(default_factory=ScanProcessingParameters)
    min_movement_between_mapping_steps: float = 0.0
    is_ignore_min_refinement_fitness: bool = False
    map_builder: MapBuilderParameters = field(default_factory=MapBuilderParameters)
    dense_map_builder: MapBuilderParameters = field(default_factory=MapBuilderParameters)
    is_build_dense_map: bool = True
    submaps: SubmapParameters = field(default_factory=SubmapParameters)
    place_recognition: PlaceRecognitionParameters = field(default_factory=PlaceRecognitionParameters)
    global_optimization: GlobalOptimizationParameters = field(default_factory=GlobalOptimizationParameters)
    is_attempt_loop_closures: bool = True
    is_dump_submaps_to_file_before_and_after_loop_closures: bool = False
    is_print_timing_statistics: bool = True
    is_refine_odometry_constraints_between_submaps: bool = False
    is_use_initial_map: bool = False
    is_merge_scans_into_map: bool = True
    mapping_buffer_size: int = 1
    map_init: MapInitializingParameters = field(default_factory=MapInitializingParameters)


@dataclass
class VisualizationParameters:  # Parameters.hpp:180-184
    assembled_map_voxel_size: float = 0.1
    submap_voxel_size: float = 0.1
    visualize_every_n_msec: float = 250.0


@dataclass
class SavingParameters:  # Parameters.hpp:186-191
    is_save_at_mission_end: bool = False
    is_save_map: bool = False
    is_save_submaps: bool = False
    is_save_dense_submaps: bool = False


@dataclass
class ConstantVelocityMotionCompensationParameters:  # Parameters.hpp:193-198
    is_undistort_input_cloud: bool = False
    is_spinning_clockwise: bool = True
    scan_duration: float = 0.1
    num_poses_velocity_estimation: int = 3


@dataclass
class CapacityParameters:
    """TPU-specific static-shape capacities (no reference equivalent —
    XLA requires fixed shapes; these bound the padded arrays)."""

    raw_scan: int = 131072          # points per raw input scan
    processed_scan: int = 16384     # after crop+voxelize (odometry/mapper input)
    submap_points: int = 262144     # sparse map cloud per submap
    dense_submap_voxels: int = 524288
    map_patch: int = 65536          # cropped map patch for scan2map matching
    feature_cloud: int = 8192       # 0.5 m-voxel cloud for FPFH
    max_submaps: int = 128
    max_constraints: int = 512
    localization_hypotheses: int = 1024


@dataclass
class SlamParameters:  # Parameters.hpp:199-205
    mapper: MapperParameters = field(default_factory=MapperParameters)
    odometry: OdometryParameters = field(default_factory=OdometryParameters)
    visualization: VisualizationParameters = field(default_factory=VisualizationParameters)
    saving: SavingParameters = field(default_factory=SavingParameters)
    motion_compensation: ConstantVelocityMotionCompensationParameters = field(
        default_factory=ConstantVelocityMotionCompensationParameters)
    capacities: CapacityParameters = field(default_factory=CapacityParameters)


# ---------------------------------------------------------------------------
# Layered loading with unused-key linting.
# ---------------------------------------------------------------------------


class ConfigError(ValueError):
    pass


def _apply_overrides(obj: Any, overrides: Dict[str, Any], path: str = "") -> Any:
    """Recursively apply a dict of overrides onto a dataclass tree.

    Unknown keys raise ConfigError naming the full dotted path — the
    linting analog of ``LuaLoader::isLoadingOkay``.
    """
    if not dataclasses.is_dataclass(obj):
        raise ConfigError(f"cannot apply dict override at non-struct path '{path}'")
    names = {f.name: f for f in dataclasses.fields(obj)}
    updates = {}
    for key, val in overrides.items():
        if key not in names:
            raise ConfigError(f"unknown parameter '{path + key}' "
                              f"(known: {sorted(names)})")
        cur = getattr(obj, key)
        if isinstance(val, dict):
            updates[key] = _apply_overrides(cur, val, path + key + ".")
        else:
            if dataclasses.is_dataclass(cur):
                raise ConfigError(f"'{path + key}' is a parameter group, got scalar")
            if isinstance(cur, tuple) and isinstance(val, list):
                val = tuple(val)
            updates[key] = type(cur)(val) if cur is not None and not isinstance(val, type(cur)) and not isinstance(cur, bool) else val
    return dataclasses.replace(obj, **updates)


def load_parameters(overrides: Optional[Dict[str, Any]] = None,
                    base: Optional[SlamParameters] = None) -> SlamParameters:
    """Defaults + optional override dict -> SlamParameters."""
    params = base or SlamParameters()
    if overrides:
        params = _apply_overrides(params, overrides)
    return params


def load_parameters_from_file(path: str, base: Optional[SlamParameters] = None) -> SlamParameters:
    """Load a YAML or JSON override file onto the defaults.

    The file may contain an ``include`` key naming another file (relative to
    it) loaded first — the reference's layered default/override pattern.
    """
    import os

    def _read(p: str) -> Dict[str, Any]:
        with open(p) as f:
            text = f.read()
        if p.endswith(".json"):
            return json.loads(text) or {}
        import yaml
        return yaml.safe_load(text) or {}

    data = _read(path)
    params = base or SlamParameters()
    include = data.pop("include", None)
    if include:
        inc_path = os.path.join(os.path.dirname(path), include)
        params = load_parameters_from_file(inc_path, base=params)
    return load_parameters(data, base=params)


def to_dict(params: Any) -> Dict[str, Any]:
    return dataclasses.asdict(params)
