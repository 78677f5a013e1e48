"""llama3-8b — GQA, 128k vocab [arXiv:2407.21783].

[dense] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
"""
from repro_torch.types import FedAttnConfig, LayerSpec, ModelConfig

SYNC_PERIOD = 4

CONFIG = ModelConfig(
    name="llama3-8b",
    arch_type="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    pattern=tuple(
        LayerSpec(kind="attn", sync=(i == SYNC_PERIOD - 1)) for i in range(SYNC_PERIOD)
    ),
    fedattn=FedAttnConfig(n_participants=16, sync_interval=SYNC_PERIOD),
    source="GQA 128k vocab [arXiv:2407.21783]",
)
