"""paddle_tpu_torch.models — the flagship model family of the port."""
from paddle_tpu_torch.models.gpt import (  # noqa: F401
    GPT, GPTConfig, gpt_loss, gpt2_small, gpt2_medium, gpt2_345m, gpt_tiny)
from paddle_tpu_torch.models.convert import (  # noqa: F401
    opt_states_from_jax, params_from_jax)
