"""qwen2-7b — GQA with QKV bias [arXiv:2407.10671].

[dense] 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
This is also the model family of the paper's own experiments (Qwen2.5).
"""
from repro_torch.types import FedAttnConfig, LayerSpec, ModelConfig

SYNC_PERIOD = 4

CONFIG = ModelConfig(
    name="qwen2-7b",
    arch_type="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_head=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    pattern=tuple(
        LayerSpec(kind="attn", sync=(i == SYNC_PERIOD - 1)) for i in range(SYNC_PERIOD)
    ),
    fedattn=FedAttnConfig(n_participants=16, sync_interval=SYNC_PERIOD),
    source="GQA, QKV bias [arXiv:2407.10671]",
)
