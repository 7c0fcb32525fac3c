"""``main serve`` / ``run_serve`` (port of the JAX package's
``serve/api.py:31-255``, without the sanitizer's retrace budget, which has
no compile to count here).

The model configures itself from the checkpoint's manifest metadata: the
user points ``--checkpoint_dir`` at a checkpoint root or one ``ckpt_<E>``
directory and sets the ``--serve_*`` group; restating ``--model`` is
optional and cross-checked (a mismatch is an error, not an override).
``--serve_draft_ckpt D --serve_spec_tokens k`` pairs a draft engine, built
from its own manifest at the target's geometry, for speculative decoding.
It serves on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import sys
import time
from typing import Any, Optional

import numpy as np
import torch

log = logging.getLogger(__name__)


def build_requests(cfg, vocab: int) -> list:
    """Requests from the CLI: ``--serve_prompt`` (comma-separated token
    ids, repeated ``--serve_requests`` times) or per-request synthetic
    prompts drawn from the served vocabulary, with the JAX package's numpy
    draws, so the same flags give the same requests."""
    from .scheduler import Request
    n = max(1, int(cfg.serve_requests))
    rng = np.random.default_rng(cfg.seed)
    out = []
    for i in range(n):
        if cfg.serve_prompt:
            ids = [int(t) for t in cfg.serve_prompt.split(",") if t.strip()]
        else:
            lo = min(4, cfg.parse_prompt_buckets()[0])
            plen = int(rng.integers(lo, cfg.parse_prompt_buckets()[0] + 1))
            ids = rng.integers(0, vocab, plen).tolist()
        out.append(Request(rid=i, prompt=ids,
                           max_new_tokens=cfg.serve_max_new_tokens,
                           temperature=cfg.serve_temperature))
    return out


def _memory(engine) -> dict:
    """What the served model holds on its device: the parameters, the two
    page pools (and the draft's, ``draft_*``, for a speculative pair), and
    the device's peak allocation (0 on the CPU)."""
    def held(eng) -> tuple[int, int]:
        params = sum(p.numel() * p.element_size()
                     for p in eng.model.parameters())
        pools = sum(t.numel() * t.element_size()
                    for t in (eng.kcache, eng.vcache))
        return params, pools

    dev = engine.device
    params, pools = held(engine)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    out = {"device": str(dev), "params_bytes": params,
           "kv_pool_bytes": pools, "max_memory_allocated": peak}
    if engine.draft is not None:
        out["draft_params_bytes"], out["draft_kv_pool_bytes"] = held(
            engine.draft)
    return out


def run_serve(cfg, requests: Optional[list] = None, *,
              model_flag_given: Optional[bool] = None) -> dict[str, Any]:
    """Load the checkpoint onto the device and serve ``requests`` (built
    from the config when None).  Returns ``{"serve": telemetry,
    "completions": [...], "requests": [...], "engine": ServeEngine}``;
    the telemetry carries the scheduler's keys (the JAX engine's),
    ``memory``, ``programs`` (the distinct (program, shape) pairs
    dispatched, a draft's under ``draft_programs``) and ``restore_ms``
    (checkpoints to engine, wall: the draft's included).

    ``model_flag_given``: whether ``--model`` was passed explicitly
    (default: given iff not the dataclass default).  Explicit and
    different from the metadata's model is an error; explicit with a
    metadata-less checkpoint rebuilds the model from the registry name
    with the vocabulary from the manifest's leaf shapes."""
    from .. import checkpoint as ckpt_lib
    from ..mesh import worker_device
    from ..models import get_model
    from .engine import ServeEngine, manifest_num_classes, resolve_checkpoint
    from .scheduler import ContinuousBatchingScheduler

    if not cfg.checkpoint_dir:
        raise ValueError("serve needs --checkpoint_dir (the sharded "
                         "checkpoint to load)")
    path = resolve_checkpoint(cfg.checkpoint_dir)
    meta = ckpt_lib.manifest_metadata(path)
    if model_flag_given is None:
        default_model = next(f.default for f in dataclasses.fields(type(cfg))
                             if f.name == "model")
        model_flag_given = cfg.model != default_model
    if model_flag_given and meta.get("model") and cfg.model != meta["model"]:
        raise ValueError(
            f"--model {cfg.model} does not match the checkpoint's recorded "
            f"model {meta['model']!r} ({path}); drop --model — serve "
            "self-configures from the manifest metadata")
    device = worker_device(0, cfg.device)
    model = None
    if not meta:
        if not model_flag_given:
            raise ValueError(
                f"checkpoint {path} carries no serve metadata (saved by a "
                "pre-metadata engine?) — restate --model gpt_*/llama_* to "
                "serve it")
        ncls = manifest_num_classes(path)
        if ncls is None:
            raise ValueError(
                f"checkpoint {path} has no tok_emb params leaf — not an "
                "autoregressive-family checkpoint, nothing to serve")
        kw: dict[str, Any] = dict(num_classes=ncls, device=device)
        if cfg.num_kv_heads:
            kw["num_kv_heads"] = cfg.num_kv_heads
        if cfg.num_experts:
            kw["num_experts"] = cfg.num_experts
            kw["capacity_factor"] = cfg.expert_capacity_factor
        model = get_model(cfg.model, **kw)
        log.info("serve: no manifest metadata; rebuilt %s (vocab %d from "
                 "manifest leaf shapes)", cfg.model, ncls)
    buckets = cfg.parse_prompt_buckets()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # one geometry for both engines of a speculative pair (the pairing
    # check enforces it); max_seq grows by k: the verify writes up to C + k
    engine_kw = dict(
        device=device, max_batch=cfg.serve_max_batch,
        page_size=cfg.serve_page_size, max_pages=cfg.serve_max_pages,
        prompt_buckets=buckets,
        max_seq=(buckets[-1] + cfg.serve_max_new_tokens
                 + cfg.serve_spec_tokens),
        seed=cfg.seed, prefix_cache=cfg.serve_prefix_cache,
        prefill_chunk=cfg.serve_prefill_chunk)
    t0 = time.perf_counter()
    draft = None
    if cfg.serve_draft_ckpt:
        # the draft configures itself from its own manifest (--model
        # belongs to the target); the pairing checks run in the target's
        # constructor below, before any request
        draft = ServeEngine.from_checkpoint(cfg.serve_draft_ckpt,
                                            **engine_kw)
    engine = ServeEngine.from_checkpoint(
        path, model=model, draft=draft, spec_tokens=cfg.serve_spec_tokens,
        **engine_kw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    restore_ms = (time.perf_counter() - t0) * 1e3
    if requests is None:
        requests = build_requests(cfg, engine.spec.vocab)
    sched = ContinuousBatchingScheduler(
        engine, eos_id=cfg.serve_eos_id,
        request_timeout=cfg.serve_request_timeout)
    telemetry = sched.run(requests)
    completions = telemetry.pop("completions")
    telemetry["memory"] = _memory(engine)
    telemetry["programs"] = sorted([name, list(shape)]
                                   for name, shape in engine.programs)
    if draft is not None:
        telemetry["draft_programs"] = sorted(
            [name, list(shape)] for name, shape in draft.programs)
    telemetry["restore_ms"] = round(restore_ms, 3)
    return {"serve": telemetry, "completions": completions,
            "requests": requests, "engine": engine}


def serve_main(argv=None) -> dict[str, Any]:
    """``main serve``: serve off a checkpoint, print each request's ids
    and one JSON telemetry line; returns ``run_serve``'s result."""
    from ..config import config_from_args
    args = sys.argv[1:] if argv is None else list(argv)
    cfg = config_from_args(args)
    logging.basicConfig(
        level=getattr(logging, cfg.log_level.upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    # an explicit --model (even the default's name) engages the mismatch
    # check and the metadata-less fallback
    given = any(a == "--model" or a.startswith("--model=") for a in args)
    results = run_serve(cfg, model_flag_given=given)
    for c in results["completions"]:
        print(f"request {c.rid}: prompt_len={c.prompt_len} "
              f"reason={c.reason} tokens={','.join(map(str, c.tokens))}")
    print("SERVE " + json.dumps(results["serve"]), flush=True)
    return results
