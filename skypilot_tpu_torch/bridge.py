"""Weights from the JAX package's Llama param tree, for the port's Llama.

`params_from_jax` takes the flax param tree as nested dicts of numpy
arrays (e.g. `jax.tree.map(np.asarray, params)` on the JAX side) and
returns the port's state_dict.  It reads both layer layouts: the
scanned `'layers'` subtree whose leaves carry a leading [L] axis (the
reference's default, `scan_layers=True`) and the unscanned `layer_i`
subtrees.  flax DenseGeneral kernels are [in, *out]; the port keeps
F.linear's [out, in]:

  q_proj [D, H, hd] -> [H*hd, D]      k/v_proj [D, kvh, hd] -> [kvh*hd, D]
  o_proj [H*hd, D]  -> [D, H*hd]      gate/up [D, F] -> [F, D]
  down   [F, D]     -> [D, F]         lm_head [D, V] -> [V, D]
  tok_embed [V, D] and the norms' `scale` [D] carry over as they are.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _tensor(x: Any) -> torch.Tensor:
    """numpy (or array-like) -> CPU tensor; bfloat16 arrays, which numpy
    holds as an extension type torch cannot read, widen to f32 exactly."""
    a = np.asarray(x)
    if a.dtype.name == 'bfloat16':
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a))


def _linear(kernel: Any) -> torch.Tensor:
    """flax [in, *out] kernel -> torch [prod(out), in]."""
    k = np.asarray(kernel)
    return _tensor(k.reshape(k.shape[0], -1).T)


def _layer(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    att = tree['attention']
    mlp = tree['mlp']
    return {
        'attention_norm.weight': _tensor(tree['attention_norm']['scale']),
        'attention.q_proj': _linear(att['q_proj']['kernel']),
        'attention.k_proj': _linear(att['k_proj']['kernel']),
        'attention.v_proj': _linear(att['v_proj']['kernel']),
        'attention.o_proj': _linear(att['o_proj']['kernel']),
        'mlp_norm.weight': _tensor(tree['mlp_norm']['scale']),
        'mlp.gate_proj': _linear(mlp['gate_proj']['kernel']),
        'mlp.up_proj': _linear(mlp['up_proj']['kernel']),
        'mlp.down_proj': _linear(mlp['down_proj']['kernel']),
    }


def _unstack(tree: Any, i: int) -> Any:
    if isinstance(tree, Mapping):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def params_from_jax(tree: Mapping[str, Any],
                    cfg: Any) -> Dict[str, torch.Tensor]:
    """The port's Llama state_dict (CPU tensors, the tree's dtypes) from
    a JAX Llama param tree of numpy arrays, scanned or unscanned."""
    if 'layers' in tree:
        layers = [_unstack(tree['layers'], i) for i in range(cfg.n_layers)]
    else:
        layers = [tree[f'layer_{i}'] for i in range(cfg.n_layers)]
    out = {
        'tok_embed': _tensor(tree['tok_embed']),
        'final_norm.weight': _tensor(tree['final_norm']['scale']),
        'lm_head': _linear(tree['lm_head']['kernel']),
    }
    for i, layer in enumerate(layers):
        for name, t in _layer(layer).items():
            out[f'layers.{i}.{name}'] = t
    return out
