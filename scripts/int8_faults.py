#!/usr/bin/env python3
"""Planted faults in the int8 branch of the paged-decode kernel must fail
chip_smoke.py's int8 kernel check.

    python3 scripts/int8_faults.py

(The ragged-prefill kernel's faults, int8 branch included, are
scripts/prefill_faults.py's; the decode kernel's split page walk's are
scripts/decode_faults.py's.)  For each fault below (four kinds in the
paged-decode kernel's quant branch), copies the port
(skypilot_tpu_torch/ and chip_smoke.py) into
skypilot_tpu_torch/_build/faults/<name>/ (git-ignored) and changes one
line of csrc/paged_decode.cu there.  The copies' kernel libraries are
built all at once, one process a copy.  Then, in each copy in turn, a
fresh process runs chip_smoke.py's device phase, its kernel phase for
the int8 branch of the decode kernel alone (the serving shape and
DECODE_EDGES), and its serve_int8 logits check (`int8_logit_gaps`) on a
llama3-8b engine at full depth with an int8 KV cache and the smoke's
weights and check prompts.  The unchanged copy runs first as the control
and must pass the kernel check; every fault must fail it.  Prints one
JSON line per run (the fault, whether the kernel check failed and the
check line that failed it, the logits gaps and whether they break
INT8_LOGITS_REL_TOL; a CUDA error fails the check and skips the gaps)
and exits 0 only when the control passes and every fault fails the
kernel check.  Needs one NVIDIA card.
"""
from __future__ import annotations

import sys

from decode_faults import run

# (name, source file under csrc/, the text as it is, the text planted)
FAULTS = (
    ('decode_key_scale_dropped', 'paged_decode.cu',
     'ksc = reinterpret_cast<const float*>(st + 2 * C::kSlabBytes)[p];',
     'ksc = 1.f;'),
    ('decode_value_scale_in_l', 'paged_decode.cu',
     '          l[r] += sc[r][n];',
     '          l[r] += sc[r][n] * (C::kQuant ? reinterpret_cast<const '
     'float*>(st + 2 * C::kSlabBytes)[kSlab + n * C::kPpw + pp] : 1.f);'),
    ('decode_scale_one_position_off', 'paged_decode.cu',
     'ksc = reinterpret_cast<const float*>(st + 2 * C::kSlabBytes)[p];',
     'ksc = reinterpret_cast<const float*>(st + 2 * C::kSlabBytes)[p ^ 1];'),
    ('decode_int8_read_as_uint8', 'paged_decode.cu',
     'static_cast<float>(static_cast<int8_t>(w[i] >> (8 * j)));',
     'static_cast<float>(static_cast<uint8_t>(w[i] >> (8 * j)));'),
)

_RUN = ('import json, torch, chip_smoke as c\n'
        'from skypilot_tpu_torch.infer import engine as engine_lib\n'
        'c.phase_device()\n'
        'dev = torch.device("cuda")\n'
        'crashed, gaps = None, None\n'
        'try:\n'
        '    c.phase_kernels(dev, quant=(True,),\n'
        '                    kernels=("paged_decode",))\n'
        '    failed = False\n'
        'except AssertionError:\n'
        '    failed = True\n'
        'except RuntimeError as e:  # a CUDA error: the run cannot go on\n'
        '    failed, crashed = True, str(e).splitlines()[0]\n'
        'if crashed is None:\n'
        '    torch.cuda.empty_cache()\n'
        '    eng = engine_lib.ContinuousBatchingEngine(\n'
        '        model="llama3-8b", n_slots=8, max_seq_len=4096,\n'
        '        prefill_chunk=512, page_size=16, kv_cache_dtype="int8",\n'
        '        device=dev)\n'
        '    gaps, _ = c.int8_logit_gaps(\n'
        '        eng, c.int8_check_prompts(eng.config.vocab_size))\n'
        'print("FAULT_RESULT " + json.dumps({\n'
        '    "kernel_check_failed": failed, "crashed": crashed,\n'
        '    "logit_gaps": gaps,\n'
        '    "logits_check_failed": None if gaps is None else not\n'
        '        max(max(g) for g in gaps) <= c.INT8_LOGITS_REL_TOL}))\n')


def main() -> int:
    return run(FAULTS, _RUN, timeout=900)


if __name__ == '__main__':
    sys.exit(main())
