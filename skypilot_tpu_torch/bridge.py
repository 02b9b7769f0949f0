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

LoRA adapters (`<proj>_lora` subtrees, a [in, rank] and b [rank,
prod(out)]) become `<part>.<proj>_lora.a` / `.b` as they are: the port
uses them as x @ a @ b too, so nothing is transposed.

A tree quantized by the reference's `quantize_params_int8` holds
{'q8', 'scale'} leaves in place of the kernels and of tok_embed: q8
takes the float leaf's place, and its scale ([1, *out], one per output
column of the flax kernel) becomes `<name>_scale` [out, 1], one per row
of the port's [out, in] weight; tok_embed's scale [1, D] carries over.
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


def _is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, Mapping) and set(leaf) == {'q8', 'scale'}


def _linear(name: str, kernel: Any) -> Dict[str, torch.Tensor]:
    """flax [in, *out] kernel -> {name: torch [prod(out), in]}; a
    quantized kernel also gives `name_scale` [prod(out), 1]."""
    if _is_quantized(kernel):
        q8 = np.asarray(kernel['q8'])
        return {name: _tensor(q8.reshape(q8.shape[0], -1).T),
                name + '_scale': _tensor(
                    np.asarray(kernel['scale']).reshape(-1, 1))}
    k = np.asarray(kernel)
    return {name: _tensor(k.reshape(k.shape[0], -1).T)}


def _embed(leaf: Any) -> Dict[str, torch.Tensor]:
    if _is_quantized(leaf):
        return {'tok_embed': _tensor(leaf['q8']),
                'tok_embed_scale': _tensor(leaf['scale'])}
    return {'tok_embed': _tensor(leaf)}


def _layer(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    out = {
        'attention_norm.weight': _tensor(tree['attention_norm']['scale']),
        'mlp_norm.weight': _tensor(tree['mlp_norm']['scale']),
    }
    for part, names in (('attention', ('q_proj', 'k_proj', 'v_proj',
                                       'o_proj')),
                        ('mlp', ('gate_proj', 'up_proj', 'down_proj'))):
        for name in names:
            out.update(_linear(f'{part}.{name}',
                               tree[part][name]['kernel']))
            adapter = tree[part].get(f'{name}_lora')
            if adapter is not None:
                out[f'{part}.{name}_lora.a'] = _tensor(adapter['a'])
                out[f'{part}.{name}_lora.b'] = _tensor(adapter['b'])
    return out


def _unstack(tree: Any, i: int) -> Any:
    if isinstance(tree, Mapping):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def params_from_jax(tree: Mapping[str, Any],
                    cfg: Any) -> Dict[str, torch.Tensor]:
    """The port's Llama state_dict (CPU tensors, the tree's dtypes) from
    a JAX Llama param tree of numpy arrays, scanned or unscanned, float
    or int8 (`quantize_params_int8`'s {'q8', 'scale'} leaves), with or
    without LoRA adapters."""
    if 'layers' in tree:
        layers = [_unstack(tree['layers'], i) for i in range(cfg.n_layers)]
    else:
        layers = [tree[f'layer_{i}'] for i in range(cfg.n_layers)]
    out = {
        **_embed(tree['tok_embed']),
        'final_norm.weight': _tensor(tree['final_norm']['scale']),
        **_linear('lm_head', tree['lm_head']['kernel']),
    }
    for i, layer in enumerate(layers):
        for name, t in _layer(layer).items():
            out[f'layers.{i}.{name}'] = t
    return out
