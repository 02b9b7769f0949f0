"""Weights from the JAX package's param trees, for the port's models.

`params_from_jax` takes a flax param tree of any ported family (llama,
qwen, gpt2, Mixtral, gemma) as nested dicts of numpy arrays (e.g.
`jax.tree.map(np.asarray, params)` on the JAX side) and returns the
port's state_dict.  It reads both layer layouts: the scanned `'layers'`
subtree whose leaves carry a leading [L] axis (the reference's default,
`scan_layers=True`) and the unscanned `layer_i` subtrees.  flax
DenseGeneral kernels are [in, *out]; the port keeps F.linear's [out, in]
and flattens the out axes:

  q_proj [D, H, hd] -> [H*hd, D]      k/v_proj [D, kvh, hd] -> [kvh*hd, D]
  o_proj [H*hd, D]  -> [D, H*hd]      gate/up [D, F] -> [F, D]
  down   [F, D]     -> [D, F]         lm_head [D, V] -> [V, D]
  gpt2's qkv_proj [D, 3, H, hd] -> [3*H*hd, D]
  Mixtral's router [D, E] -> [E, D]

A DenseGeneral bias [*out] (qwen's q/k/v, gpt2's every projection)
becomes `<proj>_bias` [prod(out)].  tok_embed [V, D], gpt2's pos_embed
[max_seq_len, D] and Mixtral's expert-stacked gate_proj / up_proj
[E, D, F] and down_proj [E, F, D] (bare params, not kernels) carry over
as they are.  RMSNorm `scale` [D] becomes `<norm>.weight` (gemma's, an
offset from 1, as stored: `GemmaRMSNorm` adds the 1); gpt2's
LayerNorms (`ln_1`, `ln_2`, `ln_f`: scale and bias) become
attention_norm, mlp_norm and final_norm `.weight` / `.bias`.  A tree
with no lm_head (a tied head: gpt2, the small qwens, gemma) gives none.

LoRA adapters (`<proj>_lora` subtrees, a [in, rank] and b [rank,
prod(out)]) become `<part>.<proj>_lora.a` / `.b` as they are: the port
uses them as x @ a @ b too, so nothing is transposed.

A tree quantized by the reference's `quantize_params_int8` holds
{'q8', 'scale'} leaves in place of the kernels and of tok_embed: q8
takes the float leaf's place, and its scale ([1, *out], one per output
column of the flax kernel) becomes `<name>_scale` [prod(out), 1], one
per row of the port's [out, in] weight; tok_embed's scale [1, D] carries
over.  Biases, norms, pos_embed and the expert stacks are float there.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

# gpt2's LayerNorm names -> the port's shared block and model names.
_NORMS = {'ln_1': 'attention_norm', 'ln_2': 'mlp_norm', 'ln_f': 'final_norm'}


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


def _norm(name: str, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """An RMSNorm {scale} or a LayerNorm {scale, bias}."""
    out = {f'{name}.weight': _tensor(tree['scale'])}
    if 'bias' in tree:
        out[f'{name}.bias'] = _tensor(tree['bias'])
    return out


def _projections(part: str, tree: Mapping[str, Any]
                 ) -> Dict[str, torch.Tensor]:
    """Every projection of one attention or MLP subtree: DenseGeneral
    kernels (and biases), LoRA adapters, bare expert stacks."""
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in tree.items():
        key = f'{part}.{name}'
        if name.endswith('_lora'):
            out[f'{key}.a'] = _tensor(leaf['a'])
            out[f'{key}.b'] = _tensor(leaf['b'])
        elif isinstance(leaf, Mapping) and 'kernel' in leaf:
            out.update(_linear(key, leaf['kernel']))
            if 'bias' in leaf:
                out[f'{key}_bias'] = _tensor(
                    np.asarray(leaf['bias']).reshape(-1))
        else:
            out[key] = _tensor(leaf)
    return out


def _layer(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for name, sub in tree.items():
        if name in ('attention', 'mlp', 'moe_mlp'):
            out.update(_projections(name, sub))
        else:
            out.update(_norm(_NORMS.get(name, name), sub))
    return out


def _unstack(tree: Any, i: int) -> Any:
    if isinstance(tree, Mapping):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def params_from_jax(tree: Mapping[str, Any],
                    cfg: Any) -> Dict[str, torch.Tensor]:
    """The port's state_dict (CPU tensors, the tree's dtypes) from a JAX
    param tree of numpy arrays of any ported family, scanned or
    unscanned, float or int8 (`quantize_params_int8`'s {'q8', 'scale'}
    leaves), with or without LoRA adapters."""
    if 'layers' in tree:
        layers = [_unstack(tree['layers'], i) for i in range(cfg.n_layers)]
    else:
        layers = [tree[f'layer_{i}'] for i in range(cfg.n_layers)]
    out = dict(_embed(tree['tok_embed']))
    if 'pos_embed' in tree:
        out['pos_embed'] = _tensor(tree['pos_embed'])
    out.update(_norm('final_norm',
                     tree['ln_f'] if 'ln_f' in tree else tree['final_norm']))
    if 'lm_head' in tree:
        out.update(_linear('lm_head', tree['lm_head']['kernel']))
    for i, layer in enumerate(layers):
        for name, t in _layer(layer).items():
            out[f'layers.{i}.{name}'] = t
    return out
