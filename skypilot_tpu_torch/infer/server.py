"""HTTP serving front-end for the port's inference engine.

Port of the /generate surface of skypilot_tpu/infer/server.py:

  GET  /health    -> 200 {"status": "ok"} once the engine is warm,
                     503 {"status": "unhealthy", ...} after a fatal
                     decode-loop failure; ?verbose=1 adds the replica's
                     detail (model, slots, page size, queue depth, the
                     allocator's leak report, the decode pipeline's
                     block, and speculation's counts on a speculating
                     engine)
  POST /generate  -> {"tokens": [[...], ...]}
       body: {"prompt_ids": [[...], ...], "max_new_tokens": N,
              "temperature": T, "top_k": K, "top_p": P, "eos_id": E,
              "seed": S, "deadline_s": D}

A dedicated decode-loop thread drives ContinuousBatchingEngine.step();
handler threads only submit() and wait().  The engine's decode pipeline
is double-buffered by default, as the reference's (--async-pipeline;
--no-async-pipeline restores the synchronous tick), and shutdown()
fences it (`close()`).  In this slice any exception
out of step() is fatal: the replica goes unhealthy and every waiter
fails fast (the reference's transient-failure recovery and restart
budget come later).  Serving random weights is refused unless
`allow_random_weights` is set.

With `continuous=False` (--no-continuous) the server runs the
request-level InferenceEngine instead: each /generate call runs
`generate` on its whole batch under a lock, with no decode loop and no
queue-depth shed; the continuous-only flags --decode-kernel,
--prefill-kernel, --page-size, --prefill-mix-budget, --spec-k and
--draft-model are refused at startup, as the reference refuses them (it
accepts --prefill-chunk and ignores it, and --async-pipeline too: the
request-level engine has no pipeline).

--spec-k K turns on speculative decoding (K proposals a step, n-gram
self-drafting, or a draft model's with --draft-model and
--draft-overrides); --prefill-mix-budget N lets up to N prompt tokens
ride each decode step instead of dedicated prefill ticks.

Weights: `params` (a state_dict), or --checkpoint-dir (the params of
the latest step of a port checkpoint, `train/checkpoint.py`; a LoRA
checkpoint serves with its adapters given the same rank:
--model-overrides '{"lora_rank": 16, "lora_alpha": 16}'), else random
weights only with --allow-random-weights.  A draft model's weights come
from --draft-checkpoint-dir, else at random from the engine's seed.

Run: python -m skypilot_tpu_torch.infer.server --model llama3-8b \
         --page-size 16 --prefill-chunk 512 --checkpoint-dir DIR
     (add --kv-cache-dtype int8 for the int8 KV cache, --quantize int8
     for int8 weights, --spec-k 4 [--draft-model llama3.2-1b] for
     speculative decoding, --prefill-mix-budget 64 for mixed batches;
     --device cpu runs on the CPU; the default
     --page-size 0 serves from a contiguous slot cache with no kernel,
     as the reference's default does)

With no argument for them, the default request deadline and the queue
bound come from SKYTPU_REQUEST_DEADLINE_S (default 600 s) and
SKYTPU_MAX_QUEUE_DEPTH (default 8 x max_batch_size), as the reference
reads them.
"""
from __future__ import annotations

import argparse
import http.server
import json
import logging
import os
import threading
import time
from typing import Any, Dict, Mapping, Optional, Sequence

import torch

from skypilot_tpu_torch import DeviceLike
from skypilot_tpu_torch.infer import engine as engine_lib

logger = logging.getLogger(__name__)

_GET_ROUTES = ('/health',)
_POST_ROUTES = ('/generate',)
# The reference's env knobs (skypilot_tpu/protocol.py ENV_CONTRACT) and
# their defaults; the queue bound's default is 8 x max_batch_size.
ENV_REQUEST_DEADLINE_S = 'SKYTPU_REQUEST_DEADLINE_S'
ENV_MAX_QUEUE_DEPTH = 'SKYTPU_MAX_QUEUE_DEPTH'
DEFAULT_REQUEST_DEADLINE_S = '600'


class _Shed(Exception):
    """Admission-time load shed: a 503 instead of queueing more work."""


class _HTTPServer(http.server.ThreadingHTTPServer):
    daemon_threads = True
    # Bursts of concurrent clients must queue in the kernel, not be
    # refused at the default backlog of 5.
    request_queue_size = 128


class InferenceServer:

    def __init__(self, model: str = 'llama-tiny', port: int = 8000,
                 host: str = '0.0.0.0', max_batch_size: int = 4,
                 max_seq_len: Optional[int] = None,
                 model_overrides: Optional[Dict[str, Any]] = None,
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 checkpoint_dir: Optional[str] = None,
                 param_dtype: Any = torch.bfloat16,
                 prefill_chunk: int = 0,
                 kv_read_bucket: int = 512,
                 page_size: int = 0,
                 max_pages: int = 0,
                 allow_random_weights: bool = False,
                 decode_kernel: str = 'auto',
                 prefill_kernel: str = 'auto',
                 kv_cache_dtype: str = 'auto',
                 quantize: Optional[str] = None,
                 spec_k: int = 0,
                 draft_model: Optional[str] = None,
                 draft_overrides: Optional[Dict[str, Any]] = None,
                 draft_checkpoint_dir: Optional[str] = None,
                 prefill_mix_budget: int = 0,
                 async_pipeline: bool = True,
                 continuous: bool = True,
                 default_deadline_s: Optional[float] = None,
                 max_queue_depth: Optional[int] = None,
                 device: DeviceLike = 'cuda') -> None:
        if params is None and checkpoint_dir is None and \
                not allow_random_weights:
            raise ValueError(
                'refusing to serve randomly initialized weights: pass '
                'params or checkpoint_dir (or allow_random_weights=True '
                'for tests/dev).')
        self.continuous = continuous
        if continuous:
            self.engine = engine_lib.ContinuousBatchingEngine(
                model=model, params=params, n_slots=max_batch_size,
                max_seq_len=max_seq_len, model_overrides=model_overrides,
                param_dtype=param_dtype, prefill_chunk=prefill_chunk,
                kv_read_bucket=kv_read_bucket, page_size=page_size,
                max_pages=max_pages, decode_kernel=decode_kernel,
                prefill_kernel=prefill_kernel,
                kv_cache_dtype=kv_cache_dtype, quantize=quantize,
                spec_k=spec_k, draft_model=draft_model,
                draft_overrides=draft_overrides,
                prefill_mix_budget=prefill_mix_budget,
                async_pipeline=async_pipeline, checkpoint_dir=checkpoint_dir,
                draft_checkpoint_dir=draft_checkpoint_dir, device=device)
        else:
            # As the reference, --prefill-chunk, --kv-read-bucket and
            # --async-pipeline are accepted and unused here.
            for flag, refused, why in (
                    ('--decode-kernel', decode_kernel != 'auto',
                     'paged decode attention is slot-mode only'),
                    ('--prefill-kernel', prefill_kernel != 'auto',
                     'chunked prefill is a slot-engine path'),
                    ('--prefill-mix-budget', prefill_mix_budget,
                     'chunked prefill is a slot-engine path'),
                    ('--page-size', page_size,
                     'the paged KV cache is slot-mode only'),
                    ('--spec-k/--draft-model', spec_k or draft_model
                     or draft_checkpoint_dir,
                     'speculation is a slot-mode decode path')):
                if refused:
                    raise ValueError(f'{flag} requires continuous batching '
                                     f'({why}); drop --no-continuous.')
            self.engine = engine_lib.InferenceEngine(
                model=model, params=params, max_batch_size=max_batch_size,
                max_seq_len=max_seq_len, model_overrides=model_overrides,
                param_dtype=param_dtype, quantize=quantize,
                kv_cache_dtype=kv_cache_dtype, checkpoint_dir=checkpoint_dir,
                device=device)
        self._lock = threading.Lock()
        self.model_name = model
        # An argument beats the env knob, which beats the default.
        self.default_deadline_s = (
            float(default_deadline_s) if default_deadline_s is not None
            else float(os.environ.get(ENV_REQUEST_DEADLINE_S,
                                      DEFAULT_REQUEST_DEADLINE_S)))
        self.max_queue_depth = (
            max_queue_depth if max_queue_depth is not None
            else int(os.environ.get(ENV_MAX_QUEUE_DEPTH,
                                    str(8 * max_batch_size))))
        # Warm the kernels and allocator before /health reports ready.
        self.engine.generate([[1, 2, 3]],
                             engine_lib.SamplingConfig(max_new_tokens=2))
        self._port = port
        self._host = host
        self._server: Optional[http.server.ThreadingHTTPServer] = None
        self._running = False
        self._decode_thread: Optional[threading.Thread] = None
        self._work = threading.Event()
        self._fatal: Optional[BaseException] = None

    def health_detail(self) -> dict:
        """The replica's detail for `GET /health?verbose=1`."""
        eng = self.engine
        detail = {'model': self.model_name, 'continuous': self.continuous}
        if self.continuous:
            detail.update(n_slots=eng.n_slots, page_size=eng.page_size,
                          queue_depth=eng.queue_depth,
                          leak_report=eng.allocator_leak_report(),
                          pipeline=eng.pipeline_info())
            spec = eng.speculation_info()
            if spec is not None:
                detail['speculation'] = spec
        return detail

    @property
    def port(self) -> int:
        assert self._server is not None
        return self._server.server_address[1]

    def _decode_loop(self) -> None:
        """Drive engine.step() while there is work; sleep on the work
        event when idle.  A step failure is fatal for the replica."""
        while self._running:
            try:
                busy = self.engine.step()
            except BaseException as e:  # noqa: BLE001 — replica boundary
                logger.exception('decode step failed; marking unhealthy')
                self._fatal = e
                self._running = False
                self.engine.abort(e)
                return
            if not busy:
                self._work.wait(0.05)
                self._work.clear()

    def _handle_generate(self, payload: dict) -> dict:
        deadline_s = payload.get('deadline_s', self.default_deadline_s)
        try:
            deadline_s = float(deadline_s)
        except (TypeError, ValueError):
            raise ValueError(f'deadline_s must be a number of seconds, '
                             f'got {deadline_s!r}') from None
        prompts = payload.get('prompt_ids')
        if not isinstance(prompts, list) or not prompts or not all(
                isinstance(p, list) for p in prompts):
            raise ValueError('prompt_ids must be a non-empty list of '
                             'token-id lists')
        sampling = engine_lib.SamplingConfig(
            temperature=float(payload.get('temperature', 0.0)),
            top_k=int(payload.get('top_k', 0)),
            top_p=float(payload.get('top_p', 1.0)),
            eos_id=payload.get('eos_id'),
            max_new_tokens=int(payload.get('max_new_tokens', 64)),
            seed=(int(payload['seed'])
                  if payload.get('seed') is not None else None))
        if not self.continuous:
            with self._lock:
                return {'tokens': self.engine.generate(prompts, sampling)}
        depth = self.engine.queue_depth
        if depth + len(prompts) > self.max_queue_depth:
            raise _Shed(f'queue full ({depth} queued, limit '
                        f'{self.max_queue_depth})')
        rids = []
        try:
            # All-or-nothing: a rejected prompt must not strand its
            # siblings decoding with no reader.
            for p in prompts:
                rids.append(self.engine.submit(p, sampling,
                                               deadline_s=deadline_s))
            self._work.set()
            tokens = [self.engine.wait(r) for r in rids]
        except BaseException:
            for r in rids:
                self.engine.cancel(r)
            raise
        return {'tokens': tokens}

    def start(self) -> None:
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):

            def log_message(self, format, *args):  # noqa: A002
                logger.debug(f'{self.address_string()} {format % args}')

            def _reply(self, code: int, body: dict,
                       allow: Optional[str] = None) -> None:
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header('Content-Type', 'application/json')
                self.send_header('Content-Length', str(len(data)))
                if allow is not None:
                    self.send_header('Allow', allow)
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802
                route, _, query = self.path.partition('?')
                if route == '/health':
                    if outer._fatal is not None:  # pylint: disable=protected-access
                        self._reply(503, {
                            'status': 'unhealthy',
                            'error': repr(outer._fatal)})  # pylint: disable=protected-access
                    elif 'verbose=1' in query.split('&'):
                        self._reply(200, dict(status='ok',
                                              **outer.health_detail()))
                    else:
                        self._reply(200, {'status': 'ok'})
                elif route in _POST_ROUTES:
                    self._reply(405, {'error': 'method not allowed'},
                                allow='POST')
                else:
                    self._reply(404, {'error': 'not found'})

            def do_POST(self):  # noqa: N802
                route = self.path.split('?', 1)[0]
                if route not in _POST_ROUTES:
                    if route in _GET_ROUTES:
                        self._reply(405, {'error': 'method not allowed'},
                                    allow='GET')
                    else:
                        self._reply(404, {'error': 'not found'})
                    return
                try:
                    length = int(self.headers.get('Content-Length', 0))
                    payload = json.loads(self.rfile.read(length) or b'{}')
                    self._reply(200, outer._handle_generate(payload))  # pylint: disable=protected-access
                except _Shed as e:
                    self._reply(503, {'error': str(e)})
                except TimeoutError as e:
                    self._reply(504, {'error': str(e)})
                except ValueError as e:
                    self._reply(400, {'error': str(e)})
                except Exception as e:  # pylint: disable=broad-except
                    logger.exception('generate failed')
                    self._reply(500, {'error': str(e)})

        self._server = _HTTPServer((self._host, self._port), Handler)
        if self.continuous and self._decode_thread is None:
            self._running = True
            self._decode_thread = threading.Thread(
                target=self._decode_loop, daemon=True,
                name='skytpu-torch-decode-loop')
            self._decode_thread.start()

    def serve_forever(self) -> None:
        """Serve until shutdown(); starts the server unless start() ran."""
        if self._server is None:
            self.start()
        assert self._server is not None
        logger.info(f'inference server on :{self.port}')
        self._server.serve_forever(poll_interval=0.05)

    def shutdown(self, join_timeout_s: float = 5.0) -> None:
        """Stop the decode loop and the HTTP server (safe to call from
        another thread than serve_forever's).  With the decode loop down
        nothing consumes a step in flight, so the engine's pipeline is
        fenced too (`close`)."""
        self._running = False
        self._work.set()
        if self._decode_thread is not None:
            self._decode_thread.join(timeout=join_timeout_s)
            self._decode_thread = None
        if self.continuous:
            self.engine.close(timeout=join_timeout_s)
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


def build_parser() -> argparse.ArgumentParser:
    """The server CLI's flags."""
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', default='llama-tiny')
    parser.add_argument('--port', type=int, default=8000)
    parser.add_argument('--host', default='0.0.0.0')
    parser.add_argument('--max-batch-size', type=int, default=4)
    parser.add_argument('--max-seq-len', type=int, default=None)
    parser.add_argument('--no-continuous', dest='continuous',
                        action='store_false', default=True,
                        help='Request-level batching (InferenceEngine) '
                             'instead of continuous (slot-based) '
                             'batching.')
    parser.add_argument('--prefill-chunk', type=int, default=0,
                        help='Chunked prefill: this many prompt tokens per '
                             'tick (0 = whole prompt at admission).')
    parser.add_argument('--kv-read-bucket', type=int, default=512)
    parser.add_argument('--page-size', type=int, default=0,
                        help='Positions per KV page (power of two); 0 = '
                             'a contiguous slot cache (no kernel).')
    parser.add_argument('--max-pages', type=int, default=0)
    parser.add_argument('--decode-kernel', default='auto',
                        choices=['auto', 'fused', 'xla'],
                        help="'fused' = the CUDA paged-decode kernel, "
                             "'xla' = its plain PyTorch version.")
    parser.add_argument('--prefill-kernel', default='auto',
                        choices=['auto', 'fused', 'xla'],
                        help="'fused' = the CUDA ragged-prefill kernel, "
                             "'xla' = its plain PyTorch version.")
    parser.add_argument('--kv-cache-dtype', default='auto',
                        choices=['auto', 'int8'],
                        help="'int8' = int8 K/V with f32 per-(kv head, "
                             "position) scales (half a bf16 cache's "
                             "bytes); 'auto' = the model dtype.")
    parser.add_argument('--quantize', default=None, choices=['int8'],
                        help='Weight-only int8: int8 matmul weights and '
                             'embedding with f32 scales, dequantized '
                             'before each use (half the weight bytes); '
                             'composes with --kv-cache-dtype.')
    parser.add_argument('--model-overrides', default=None,
                        help='JSON dict of model-config overrides.')
    parser.add_argument('--checkpoint-dir', default=None,
                        help='Serve the params of the latest step of this '
                             'port checkpoint (train/checkpoint.py).')
    parser.add_argument('--spec-k', type=int, default=0,
                        help='Speculative tokens proposed a decode step (0 '
                             'disables speculation); without --draft-model '
                             'they come from n-gram prompt lookup.  Greedy '
                             'output is unchanged, sampled output keeps '
                             'its distribution (rejection sampling).')
    parser.add_argument('--draft-model', default=None,
                        help='Draft model for speculative decoding (same '
                             'vocabulary as --model, checked at startup); '
                             'requires --spec-k.')
    parser.add_argument('--draft-overrides', default=None,
                        help='JSON dict of draft-model config overrides.')
    parser.add_argument('--draft-checkpoint-dir', default=None,
                        help='The draft model\'s weights: the params of the '
                             'latest step of this port checkpoint (default: '
                             'random, from the engine seed).')
    parser.add_argument('--async-pipeline', dest='async_pipeline',
                        action='store_true', default=True,
                        help='Double-buffered decode stepping: the host '
                             'front of a tick runs while the step '
                             'dispatched last tick runs on the device, '
                             'then that step is joined and the next '
                             'dispatched.  Streams stay those of the '
                             'synchronous loop.  Default on.')
    parser.add_argument('--no-async-pipeline', dest='async_pipeline',
                        action='store_false',
                        help='The synchronous decode loop: dispatch, fetch '
                             'and commit inline each tick.')
    parser.add_argument('--prefill-mix-budget', type=int, default=0,
                        help='Mixed prefill/decode batches: up to this many '
                             'prompt tokens ride each decode step (0 = '
                             'dedicated prefill ticks).')
    parser.add_argument('--allow-random-weights', action='store_true',
                        help='Serve randomly initialized weights without '
                             '--checkpoint-dir (tests/dev).')
    parser.add_argument('--device', default='cuda')
    return parser


def _json_object(parser: argparse.ArgumentParser, flag: str,
                 text: Optional[str]) -> Optional[dict]:
    if not text:
        return None
    value = json.loads(text)
    if not isinstance(value, dict):
        parser.error(f'{flag} must be a JSON object')
    return value


def check_args(parser: argparse.ArgumentParser,
               args: argparse.Namespace) -> None:
    """The flag combinations the parser refuses (argparse's exit 2)."""
    if args.draft_model and not args.spec_k:
        parser.error('--draft-model requires --spec-k > 0')


def server_from_args(argv: Optional[Sequence[str]] = None
                     ) -> InferenceServer:
    """The server the CLI runs for `argv` (default sys.argv), built and
    warm but not yet serving."""
    parser = build_parser()
    args = parser.parse_args(argv)
    check_args(parser, args)
    overrides = _json_object(parser, '--model-overrides',
                             args.model_overrides)
    draft_overrides = _json_object(parser, '--draft-overrides',
                                   args.draft_overrides)
    return InferenceServer(
        model=args.model, port=args.port, host=args.host,
        max_batch_size=args.max_batch_size, max_seq_len=args.max_seq_len,
        model_overrides=overrides, checkpoint_dir=args.checkpoint_dir,
        prefill_chunk=args.prefill_chunk,
        kv_read_bucket=args.kv_read_bucket, page_size=args.page_size,
        max_pages=args.max_pages,
        allow_random_weights=args.allow_random_weights,
        decode_kernel=args.decode_kernel,
        prefill_kernel=args.prefill_kernel,
        kv_cache_dtype=args.kv_cache_dtype, quantize=args.quantize,
        spec_k=args.spec_k, draft_model=args.draft_model,
        draft_overrides=draft_overrides,
        draft_checkpoint_dir=args.draft_checkpoint_dir,
        prefill_mix_budget=args.prefill_mix_budget,
        async_pipeline=args.async_pipeline, continuous=args.continuous,
        device=args.device)


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO)
    t0 = time.perf_counter()
    server = server_from_args(argv)
    logger.info(f'engine ready in {time.perf_counter() - t0:.1f}s')
    server.serve_forever()


if __name__ == '__main__':
    main()
