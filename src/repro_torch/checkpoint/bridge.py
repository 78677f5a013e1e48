"""Weight bridge: the JAX ``TransformerLM.init`` tree → the port's params,
and a JAX paged pool cache → the port's pool (:func:`pool_from_numpy`).

The JAX package keys its parameter tree by path (``checkpoint/npz.py``
``_flatten``: ``layers/3/attn/wq``). The port keeps those paths and the
JAX ``(in, out)`` layouts, so the bridge is a copy plus a check that the
key set is exactly the one the config implies:

  embed/tok                      (padded_vocab, d)
  layers/i/norm1/scale           (d,)
  layers/i/attn/wq               (d, nq*dh)    wk, wv (d, nkv*dh)
  layers/i/attn/wo               (nq*dh, d)    bq, bk, bv (qkv_bias only)
  layers/i/norm2/scale           (d,)
  layers/i/ffn/w_gate, w_up      (d, d_ff)     w_down (d_ff, d)
  final_norm/scale               (d,)
  head/w                         (d, padded_vocab), absent when tied
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.transformer import check_supported
from repro_torch.types import ModelConfig


def flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """Path-keyed leaves of a nested dict/list tree (``layers/3/attn/wq``)."""
    out: dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def expected_shapes(config: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Every parameter path of ``config`` with its shape."""
    check_supported(config)
    d, dh, f = config.d_model, config.head_dim, config.d_ff
    nq, nkv, Vp = config.n_heads, config.n_kv_heads, config.padded_vocab
    shapes: dict[str, tuple[int, ...]] = {"embed/tok": (Vp, d), "final_norm/scale": (d,)}
    if not config.tie_embeddings:
        shapes["head/w"] = (d, Vp)
    for i in range(config.n_layers):
        pre = f"layers/{i}/"
        shapes.update({
            pre + "norm1/scale": (d,),
            pre + "norm2/scale": (d,),
            pre + "attn/wq": (d, nq * dh),
            pre + "attn/wk": (d, nkv * dh),
            pre + "attn/wv": (d, nkv * dh),
            pre + "attn/wo": (nq * dh, d),
        })
        if config.qkv_bias:
            shapes.update({
                pre + "attn/bq": (nq * dh,),
                pre + "attn/bk": (nkv * dh,),
                pre + "attn/bv": (nkv * dh,),
            })
        if config.qk_norm:
            shapes.update({pre + "attn/q_norm": (dh,), pre + "attn/k_norm": (dh,)})
        if config.ffn_activation == "swiglu":
            shapes[pre + "ffn/w_gate"] = (d, f)
        shapes.update({pre + "ffn/w_up": (d, f), pre + "ffn/w_down": (f, d)})
    return shapes


def _to_tensor(a: Any, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: exact through float32
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":  # ml_dtypes: the same bits
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree: Any, config: ModelConfig, device) -> dict:
    """The port's parameter dict from a JAX ``TransformerLM.init`` tree whose
    leaves are numpy arrays. Unknown or missing paths, and wrong shapes,
    raise ``ValueError``."""
    flat = flatten(tree)
    want = expected_shapes(config)
    missing, unknown = sorted(set(want) - set(flat)), sorted(set(flat) - set(want))
    if missing or unknown:
        raise ValueError(f"weight bridge: missing {missing}, unknown {unknown}")
    for key, shape in want.items():
        if tuple(np.shape(flat[key])) != shape:
            raise ValueError(f"weight bridge: {key} has shape {np.shape(flat[key])}, expected {shape}")
    t = lambda key: _to_tensor(flat[key], device)
    layer_keys = lambda i, part: sorted(
        k.split("/")[-1] for k in want if k.startswith(f"layers/{i}/{part}/")
    )
    return {
        "embed": {"tok": t("embed/tok")},
        "layers": [
            {
                part: {name: t(f"layers/{i}/{part}/{name}") for name in layer_keys(i, part)}
                for part in ("norm1", "attn", "norm2", "ffn")
            }
            for i in range(config.n_layers)
        ],
        "final_norm": {"scale": t("final_norm/scale")},
        "head": {} if config.tie_embeddings else {"w": t("head/w")},
    }


_POOL_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8,
    "float8_e4m3fn": torch.float8_e4m3fn,
}


def pool_from_numpy(layers: Any, config: ModelConfig, device) -> list[dict]:
    """The port's paged pool cache (:func:`repro_torch.models.transformer.
    init_paged_cache`) from a JAX loop-form paged cache whose leaves are
    numpy arrays: one dict per layer with ``pk``/``pv`` (num_pages,
    page_size, nkv, dh), optional ``sk``/``sv`` (num_pages, nkv) f32 and
    ``am`` (slots, capacity) f32. Codes and scales carry over bit for bit.
    Unknown leaves, wrong shapes or dtypes raise ``ValueError``."""
    check_supported(config)
    if len(layers) != config.n_layers:
        raise ValueError(f"pool bridge: {len(layers)} layers, expected {config.n_layers}")
    nkv, dh = config.n_kv_heads, config.head_dim
    out = []
    for i, layer in enumerate(layers):
        keys = set(layer)
        if not ({"pk", "pv"} <= keys <= {"pk", "pv", "sk", "sv", "am"}) or ("sk" in keys) != ("sv" in keys):
            raise ValueError(f"pool bridge: layer {i} has leaves {sorted(keys)}")
        pk = np.asarray(layer["pk"])
        if pk.ndim != 4 or pk.shape[2:] != (nkv, dh) or np.shape(layer["pv"]) != pk.shape:
            raise ValueError(f"pool bridge: layer {i} pool shape {pk.shape}")
        if pk.dtype.name not in _POOL_DTYPES:
            raise ValueError(f"pool bridge: layer {i} pool dtype {pk.dtype}")
        if "sk" in keys:
            for name in ("sk", "sv"):
                sc = np.asarray(layer[name])
                if sc.shape != (pk.shape[0], nkv) or sc.dtype != np.float32:
                    raise ValueError(f"pool bridge: layer {i} {name} is {sc.dtype}{sc.shape}")
        out.append({k: _to_tensor(layer[k], device) for k in sorted(keys)})
    return out
