"""Qwen2.5 ladder — the paper's own experimental backbones (§VII-A1).

The paper evaluates FedAttn on Qwen2.5 base models at 0.5B/1.5B/3B/7B with
GSM8K. These configs carry the published architecture hyperparameters; the
paper-claims experiments (benchmarks/fig5..fig10) run `reduced()` variants
trained from scratch on synthetic multi-segment tasks, since pretrained
weights are unavailable offline. The port runs them with random weights
made from a seed.
"""
from repro_torch.types import FedAttnConfig, LayerSpec, ModelConfig


def _qwen25(name, n_layers, d_model, n_heads, n_kv, d_ff, tie, sync_period=4):
    return ModelConfig(
        name=name,
        arch_type="dense",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_ff=d_ff,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        tie_embeddings=tie,
        pattern=tuple(
            LayerSpec(kind="attn", sync=(i == sync_period - 1))
            for i in range(sync_period)
        ),
        fedattn=FedAttnConfig(n_participants=4, sync_interval=sync_period),
        source="Qwen2.5 [arXiv:2412.15115] — the paper's backbone",
    )


QWEN25_05B = _qwen25("qwen2.5-0.5b", 24, 896, 14, 2, 4864, True)
QWEN25_15B = _qwen25("qwen2.5-1.5b", 28, 1536, 12, 2, 8960, True)
QWEN25_3B = _qwen25("qwen2.5-3b", 36, 2048, 16, 2, 11008, True)
QWEN25_7B = _qwen25("qwen2.5-7b", 28, 3584, 28, 4, 18944, False)

LADDER = {c.name: c for c in (QWEN25_05B, QWEN25_15B, QWEN25_3B, QWEN25_7B)}
