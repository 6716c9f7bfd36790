"""The serving package. The server is imported here; the int8 path
(quant.py, which imports the model) and the export bundles (export.py)
are imported when one of their names is first read, so that serving a
bundle (`ArtifactEngine`) imports no model code."""
import importlib

from automoe_tpu_torch.serving.server import (  # noqa: F401
    BatchingServer,
    Client,
    serve_tcp,
)

_LAZY = {
    **dict.fromkeys(("ArtifactEngine", "export_serving_step", "load_serving_step",
                     "save_serving_artifact", "save_serving_bundle"), "export"),
    **dict.fromkeys(("calibrate_automoe", "fold_resnet", "make_quant_forward",
                     "prepare_qexperts", "quantize_automoe", "quantize_folded",
                     "resnet_float_forward", "resnet_quant_forward",
                     "resnet_quant_forward_q8", "stems_s2d_q8"), "quant"),
}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
