"""paddle_tpu_torch.models — the flagship model families of the port."""
from paddle_tpu_torch.models.gpt import (  # noqa: F401
    GPT, GPTConfig, gpt_loss, gpt2_small, gpt2_medium, gpt2_345m, gpt_tiny)
from paddle_tpu_torch.models.bert import (  # noqa: F401
    Bert, BertConfig, Ernie, ErnieConfig, bert_base, bert_pretrain_loss,
    bert_tiny)
from paddle_tpu_torch.models.convert import (  # noqa: F401
    BERT_MP_SPLITS, full_opt_states, full_params, load_embedding_table,
    load_named_buffers, load_named_params, opt_states_from_jax,
    params_from_jax, ps_tables_from_jax, shard_opt_states, shard_params,
    state_dict_from_jax)
from paddle_tpu_torch.models.rank import (  # noqa: F401
    DeepFM, WideDeep, WideDeepHost)
