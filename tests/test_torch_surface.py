"""Every public function and class of the JAX package has a counterpart of
the same name in the port's module of the same path, but for the names
below, which have one under another name or need none (ROADMAP.md, "Open
items"). An AST pass over the sources; nothing is imported."""

import ast
import pathlib

REPO = pathlib.Path(__file__).resolve().parent.parent

NO_COUNTERPART = {
    # the Pallas entry points and the TPU dispatch: the CUDA wrappers of
    # ops/deform_conv.py and ops/soft_nms.py take their place
    "ops/dcn.py": {"deform_conv2d_auto"},
    "ops/pallas_dcn.py": {"bwd_fits_vmem", "deform_conv2d_fused",
                          "deform_conv2d_pallas", "deform_conv2d_pallas_bwd",
                          "fits_vmem"},
    "ops/pallas_nms.py": {"soft_nms_auto", "soft_nms_pallas",
                          "soft_nms_pallas_classes"},
    "parallel/mesh.py": {"create_mesh"},        # parallel.create_group
    "train/state.py": {"make_optimizer"},       # optax plumbing
    "utils/cache.py": {"enable_compilation_cache"},     # XLA's cache
    # OIHW -> HWIO: the port keeps the reference's OIHW layout
    "utils/convert.py": {"torch_conv_to_flax", "torch_linear_to_flax"},
}


def public_names(path):
    if not path.exists():
        return set()
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def test_every_public_name_has_a_port_counterpart():
    missing = {}
    for src in sorted((REPO / "rrnet_tpu").rglob("*.py")):
        rel = src.relative_to(REPO / "rrnet_tpu").as_posix()
        gone = public_names(src) - public_names(REPO / "rrnet_torch" / rel)
        if gone:
            missing[rel] = gone
    assert missing == NO_COUNTERPART
