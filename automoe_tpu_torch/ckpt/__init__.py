from automoe_tpu_torch.ckpt.from_jax import (  # noqa: F401
    deep_policy_state_dict_from_jax,
    expert_state_dict_from_jax,
    gating_state_dict_from_jax,
    load_torch_state_dict,
    policy_state_dict_from_jax,
    state_dict_from_jax,
)
from automoe_tpu_torch.ckpt.checkpoint import (  # noqa: F401
    CheckpointManager,
    load_checkpoint,
    load_variables,
    state_dict_from_checkpoint,
)
from automoe_tpu_torch.ckpt.compose import load_expert_checkpoints  # noqa: F401
