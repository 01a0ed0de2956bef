"""What of the JAX package the port still lacks, by name: a walk of both
packages' top-level public functions and classes (``ast``, no import).
Every JAX name the port does not define is listed here with the reason it
is not ported; a slice that ports one takes it off the list, and a name
that goes missing fails the test."""

import ast
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ITEM_14 = "ROADMAP Queue 1, item 14: host utilities, not on a model path"
FLAX = ("a flax idiom: the port builds torch modules and their arguments "
        "directly")
UNPORTED = {
    # item 14, still to port
    **{name: ITEM_14 for name in (
        "ActivationRecorder", "check_diff", "compare_data",
        "compare_recordings", "format_report",             # check_diff.py
        "compare_trees", "convert_tensor", "load_reference_checkpoint",
        "torch_state_to_flax",                             # checkpoint_convert
        "colors_val", "draw_hbb", "draw_obb", "draw_poly",
        "get_img_from_fig", "plt_init", "random_colors",
        "single_color_val",                                # draw.py
        "visualize_dota",                                  # visualization.py
        "parse_losses", "set_random_seed", "sync", "to_np", "unmap",
        "multi_apply")},                                   # general.py
    # the TPU's own, with the port's counterpart named
    "fast_top_k": "the TPU's approximate top-k; the port's ops/nms.py:top_k "
                  "is exact",
    "roi_align_rotated_pyramid_pallas": "a Pallas entry point; K1 / K3 "
                                        "behind ops/roi_align.py:"
                                        "roi_align_rotated_pyramid",
    "dw_wgrad_pallas": "a Pallas entry point; K6 behind ops/dw_conv.py",
    "tap_bwd_enabled": "the RS_DW_TAP_BWD switch of the Pallas path; the "
                       "port trains every depthwise conv through K6",
    "wgrad_pallas_enabled": "the switch of the Pallas weight gradient; the "
                            "port always takes K6",
    "int8_enabled": "the RS_INT8 switch; the port takes int8= arguments",
    "MaybeInt8Conv": FLAX + " (ops/quant.py:int8_conv)",
    "Norm": FLAX + " (models/utils/modules.py:BatchNorm2d)",
    "ConvModule": FLAX,
    "kaiming_normal_fanout": FLAX + " (flagship.init_weights)",
    "norm_kind_from_cfg": FLAX,
    "optax_sigmoid_bce": "optax's BCE; the port's losses call torch's "
                         "binary_cross_entropy_with_logits",
    "make_decayed_tx": "an optax chain; the port's optims/optimizer.py",
    "TrainState": "the JAX training state; the port trains the module "
                  "in place (parallel/train_step.py:train_step)",
    "create_train_state": "the JAX training state; see TrainState",
    "make_train_step": "a jitted JAX step; parallel/train_step.py:"
                       "train_step",
    "create_mesh": "the JAX device mesh; parallel/dist.py",
    "shardings": "the JAX mesh's shardings; parallel/dist.py:rows",
    # the native tile decoder stays unported (ROADMAP item 0)
    "decode_batch": "the native tile decoder; the port decodes with PIL",
    "decode_image": "the native tile decoder; the port decodes with PIL",
    "get_lib": "the JAX package's native loader; native/__init__.py:"
               "poly_nms_library",
    "poly_iou_batch_native": "the native poly IoU of the JAX package; "
                             "ops/nms_poly.py computes it in numpy",
}


def _names(package):
    root = os.path.join(REPO, package)
    out = set()
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    tree = ast.parse(fh.read())
                out |= {n.name for n in tree.body if isinstance(
                    n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
                    and not n.name.startswith("_")}
    return out


def test_the_unported_jax_names_are_the_listed_ones():
    missing = _names("rs_detection_tpu") - _names("rs_detection_tpu_torch")
    assert missing == set(UNPORTED), (
        sorted(missing - set(UNPORTED)), sorted(set(UNPORTED) - missing))
    assert all(reason.strip() for reason in UNPORTED.values())


def test_the_toolbox_names_are_ported():
    """Items 10c and 1 of ROADMAP Queue 1: each name exists in the port
    at the counterpart path (the module's own ``ast``, and the
    ``ROIAlignRotated_v1`` alias by its assignment)."""
    expect = {
        "ops/roi_align.py": ["psroi_align", "PSROIAlign", "roi_pool",
                             "roi_align_rotated", "ROIAlignRotated",
                             "ROIAlignRotated_v1"],
        "ops/dcn_pool.py": ["deform_roi_pooling", "DCNPooling"],
        "models/roi_heads/legacy_creators.py": [
            "bbox2loc", "loc2bbox", "bbox_iou", "AnchorTargetCreator",
            "ProposalCreator", "ProposalTargetCreator"],
        "ops/bbox_transforms.py": [
            "hbb2obb_v2", "dbbox2delta_v2", "delta2dbbox_v2",
            "dbbox2delta_v3", "delta2dbbox_v3", "choose_best_match_batch",
            "best_match_dbbox2delta", "choose_best_Rroi_batch",
            "choose_best_obb_batch", "roi2droi",
            "polygonToRotRectangle_batch", "mask2poly_single", "mask2poly",
            "gt_mask_bp_obbs", "gt_mask_bp_obbs_list", "dbbox2result"],
        "ops/bbox_geometry.py": ["bbox_overlaps", "bbox_areas", "bbox_nms",
                                 "bbox_area_nms"],
        "ops/box_ops.py": ["arb2roi", "bbox2roi", "get_bbox_dim",
                           "get_bbox_type", "get_best_begin_point",
                           "poly_to_rotated_box", "rotated_box_to_bbox"],
        "ops/rotated_iou.py": ["poly_iou", "box_iou_rotated_v1"],
        "ops/nms.py": ["nms", "nms_mask", "multiclass_nms"],
        "ops/nms_poly.py": ["multiclass_poly_nms"],
        "models/boxes/anchor_target.py": ["anchor_inside_flags",
                                          "images_to_levels"],
        "models/boxes/iou_calculator.py": ["bbox_overlaps_np"],
        "data/devkits/result_merge.py": ["mergebyobb"],
        "ops/deform_conv.py": ["dcn_offset_grid"],
    }
    for rel, names in expect.items():
        with open(os.path.join(REPO, "rs_detection_tpu_torch", rel)) as fh:
            tree = ast.parse(fh.read())
        defined = {n.name for n in tree.body if isinstance(
            n, (ast.FunctionDef, ast.ClassDef))}
        defined |= {t.id for n in tree.body if isinstance(n, ast.Assign)
                    for t in n.targets if isinstance(t, ast.Name)}
        assert set(names) <= defined, (rel, sorted(set(names) - defined))


def test_the_port_imports_no_jax_opencv_or_shapely():
    """Statically (``ast``, every import anywhere in a module): the port's
    modules and ``chip_smoke.py`` import neither the JAX stack, nor the
    JAX package, nor OpenCV or shapely, none of which the port depends
    on; ``ops/min_area_rect.py`` stands in for OpenCV's rectangles."""
    banned = {"jax", "jaxlib", "flax", "optax", "cv2", "shapely",
              "rs_detection_tpu"}
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(d, f)
        for d, _, fs in os.walk(os.path.join(REPO, "rs_detection_tpu_torch"))
        for f in fs if f.endswith(".py")]
    found = []
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            found += [(os.path.relpath(path, REPO), m) for m in mods
                      if m.split(".")[0] in banned]
    assert len(files) > 100 and not found, found
