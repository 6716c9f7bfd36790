from automoe_tpu_torch.configs.config import (  # noqa: F401
    AutoMoEConfig,
    ContextConfig,
    ExpertConfig,
    GatingConfig,
    PolicyConfig,
    load_model_config,
    default_model_config,
)
