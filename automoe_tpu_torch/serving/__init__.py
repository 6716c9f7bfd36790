from automoe_tpu_torch.serving.server import (  # noqa: F401
    BatchingServer,
    Client,
    serve_tcp,
)
from automoe_tpu_torch.serving.quant import (  # noqa: F401
    calibrate_automoe,
    fold_resnet,
    make_quant_forward,
    prepare_qexperts,
    quantize_automoe,
    quantize_folded,
    resnet_float_forward,
    resnet_quant_forward,
    resnet_quant_forward_q8,
    stems_s2d_q8,
)
