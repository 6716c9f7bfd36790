from automoe_tpu_torch.ckpt.from_jax import (  # noqa: F401
    expert_state_dict_from_jax,
    load_torch_state_dict,
    state_dict_from_jax,
)
