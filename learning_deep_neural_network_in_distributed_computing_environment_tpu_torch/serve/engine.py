"""``ServeEngine``: the paged KV pools, the fixed-shape device programs
and the checkpoint loader of the serving stack (port of the JAX package's
``serve/engine.py``, with its speculative pair).

The programs, each one shape:

- **prefill** — one shape per prompt-length bucket, ``[1, bucket]`` tokens
  at a cache offset (0 for a cold prompt, the hit length when a
  prefix-cache hit leaves only the tail).  The padding rows write to the
  trash page; the logits are taken at the last real position.  With
  ``prefill_chunk=C`` one ``[1, C]`` chunk program replaces the buckets.
- **decode** — one ``[max_batch, 1]`` step advancing every active slot a
  token; inactive rows write to the trash page.
- **verify** — a target paired with a draft engine (``draft=``,
  ``spec_tokens=k``) scores a speculation burst in one ``[max_batch,
  k+1]`` forward at the current lengths, writes the target's keys and
  values for positions ``C .. C+k``, and runs ``speculative_accept`` on
  the device; only ``(emitted, acc)`` cross to the host, in one copy.
  Its plain decode never runs; the draft runs its own prefill and
  ``[max_batch, 1]`` decode.

PyTorch runs them eagerly: there is no compile to count, so the engine
records the distinct ``(program, shape)`` pairs it dispatched
(``programs``), the counterpart of the JAX engine's zero-retrace gate, and
refuses a call of another shape.  Each program is a
``probe.TrackedProgram`` (the prefill one row per bucket), whose memory
rows ``memory_programs`` hands to ``probe.memory_report``.

``from_checkpoint`` builds the model from a checkpoint's MANIFEST
metadata and loads worker 0's ``params`` row, one shard file at a time
with the manifest's size and crc32 checks, so the other workers' rows and
the optimizer state never become tensors.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Optional

import numpy as np
import torch

from .. import checkpoint as ckpt_lib
from .. import weights
from ..probe import TrackedProgram
from ..models import decode as D
from ..models import get_model
from ..utils.batching import pad_to_bucket, pick_bucket
from .cache import PageAllocator, page_table_row, pages_needed

log = logging.getLogger(__name__)


def load_params_row0(path: str, model) -> None:
    """Load worker 0's row of a committed sharded epoch's ``.params``
    leaves into ``model`` (strictly: every parameter, no other)."""
    manifest = ckpt_lib.read_manifest(path)
    if not manifest:
        raise FileNotFoundError(f"no committed manifest under {path}")
    row = ckpt_lib.load_row(path, manifest, 0,
                            keep=lambda k: k.startswith(".params["))
    if row:
        sd = weights.params_from_jax_leaves(row, weights.state_layout(model))
    elif any(k.startswith(".params_resident[") for k in manifest["leaves"]):
        sd = _resident_params(path, manifest, model)
    else:
        raise ValueError(f"checkpoint {path} has no params leaves")
    device = next(model.parameters()).device
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           .to(device) for k, v in sd.items()}, strict=True)


def _resident_params(path: str, manifest: dict, model) -> dict:
    """The consensus of a scatter-resident checkpoint (``.params_resident``
    rows, JAX ``load_params_resident``): its rows gathered on the host and
    unpacked by the model's wire layout and the manifest's bucket size."""
    from .. import comms
    keys = [k for k in manifest["leaves"]
            if k.startswith(".params_resident[")]
    full, _epoch = ckpt_lib.host_tree(path, keep=lambda k: k in keys)
    mb = manifest.get("metadata", {}).get("sync_bucket_mb")
    named = list(model.named_parameters())
    template = comms.ParamsTemplate.of(
        [n for n, _p in named], [p for _n, p in named],
        comms.WireLayout(*weights.wire_layout(model)))
    tensors = comms.resident_to_tree(
        {k[len(".params_resident['"):-2]: v for k, v in full.items()},
        template=template,
        bucket_bytes=(int(float(mb) * (1 << 20)) if mb
                      else comms.DEFAULT_BUCKET_BYTES))
    return dict(zip(template.names, tensors))


def manifest_num_classes(path: str) -> Optional[int]:
    """The vocabulary from the manifest's ``.params['tok_emb']['embedding']``
    shape ``[workers, vocab, hidden]``: the fallback that serves a
    metadata-less checkpoint under an explicit ``--model``."""
    manifest = ckpt_lib.read_manifest(path)
    info = (manifest or {}).get("leaves", {}).get(
        ".params['tok_emb']['embedding']")
    if not info or len(info.get("shape", ())) != 3:
        return None
    return int(info["shape"][1])


def model_from_metadata(meta: dict, device=None):
    """The serving model rebuilt from a checkpoint's manifest metadata."""
    name = meta.get("model", "")
    if not name.startswith(("gpt", "llama")):
        raise ValueError(
            f"checkpoint was trained with --model {name!r}; serving "
            "supports the autoregressive families (gpt_*/llama_*)")
    if not meta.get("scan_layers", False):
        raise ValueError(
            "checkpoint was saved with an unrolled (non-layer-scan) "
            "parameter layout; serving decodes over the stacked stack — "
            "retrain/save with --layer_scan auto|on")
    dtype = (torch.bfloat16 if meta.get("compute_dtype") == "bfloat16"
             else torch.float32)
    kw: dict[str, Any] = dict(num_classes=int(meta["num_classes"]),
                              dtype=dtype, device=device)
    if meta.get("num_kv_heads"):
        kw["num_kv_heads"] = int(meta["num_kv_heads"])
    if meta.get("num_experts"):
        kw["num_experts"] = int(meta["num_experts"])
        kw["capacity_factor"] = float(meta.get("capacity_factor", 1.25))
    return get_model(name, **kw)


def resolve_checkpoint(ckpt_dir: str) -> str:
    """A committed ``ckpt_<E>`` directory: ``ckpt_dir`` itself, or the
    newest one under it."""
    if os.path.isfile(os.path.join(ckpt_dir, ckpt_lib.MANIFEST)):
        return ckpt_dir
    path = ckpt_lib.latest_checkpoint(ckpt_dir)
    if path is None:
        raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    if not os.path.isdir(path):
        raise ValueError(
            f"{path} is a legacy single-file checkpoint; serving loads the "
            "sharded (format 2) layout (the legacy restore is the rest of "
            "ROADMAP queue A.9)")
    return path


class ServeEngine:
    """Paged-KV inference engine for one model (its parameters where the
    module holds them).  ``max_seq`` bounds the positions a sequence may
    reach (page-table width ``ceil(max_seq / page_size)``); defaults to
    twice the largest prompt bucket.  The continuous-batching policy
    lives in ``serve.scheduler``."""

    def __init__(self, model, *, max_batch: int = 4, page_size: int = 16,
                 max_pages: int = 64, prompt_buckets=(16, 64),
                 max_seq: Optional[int] = None, seed: int = 0,
                 prefix_cache: bool = False, prefill_chunk: int = 0,
                 draft: Optional["ServeEngine"] = None,
                 spec_tokens: int = 0):
        self.spec = D.spec_from_model(model)
        self.model = model.eval()
        self.device = next(model.parameters()).device
        if page_size < 1 or max_batch < 1:
            raise ValueError(
                f"page_size ({page_size}) and max_batch ({max_batch}) "
                "must be >= 1")
        buckets = tuple(sorted(set(int(b) for b in prompt_buckets)))
        if not buckets or buckets[0] < 1:
            raise ValueError(
                f"prompt_buckets must be positive lengths, got "
                f"{prompt_buckets}")
        self.prompt_buckets = buckets
        self.max_batch = int(max_batch)
        self.page_size = int(page_size)
        self.max_seq = int(max_seq) if max_seq else 2 * buckets[-1]
        if self.max_seq < buckets[-1]:
            raise ValueError(
                f"max_seq {self.max_seq} below the largest prompt bucket "
                f"{buckets[-1]}")
        if self.spec.max_len and self.max_seq > self.spec.max_len:
            raise ValueError(
                f"max_seq {self.max_seq} exceeds the model's position "
                f"table ({self.spec.max_len})")
        self.pages_per_seq = pages_needed(self.max_seq, self.page_size)
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 0 or (self.prefill_chunk
                                      and self.prefill_chunk
                                      % self.page_size):
            raise ValueError(
                f"prefill_chunk must be a positive multiple of page_size "
                f"({self.page_size}) so chunk boundaries land on page "
                f"boundaries, got {self.prefill_chunk}")
        self.prefix_cache = bool(prefix_cache)
        if self.prefix_cache and self.pages_per_seq >= max_pages - 1:
            raise ValueError(
                f"prefix_cache needs page-pool headroom beyond one "
                f"max-length sequence: a {self.max_seq}-token sequence "
                f"pins {self.pages_per_seq} of the {max_pages - 1} usable "
                f"pages (page 0 is the trash page), so nothing could ever "
                f"stay cached — raise max_pages")
        self.allocator = PageAllocator(max_pages)
        self.seed = int(seed)
        self.kcache, self.vcache = D.init_paged_cache(
            self.spec, max_pages, self.page_size, self.device)
        self.compiled_buckets: list[int] = []
        self.programs: set[tuple[str, tuple[int, ...]]] = set()
        self.draft = draft
        self.spec_tokens = int(spec_tokens)
        self._check_pair()
        # the programs' memory rows: each reads the parameters and writes
        # the page pools in place
        self._decode = TrackedProgram("decode_step", self._forward,
                                      state=self._held)
        self._prefill = TrackedProgram("prefill", self._forward,
                                       multi_shape=True, state=self._held)
        self._chunk = (TrackedProgram("prefill_chunk", self._forward,
                                      state=self._held)
                       if self.prefill_chunk else None)
        self._verify = (TrackedProgram("verify", self._verify_program,
                                       state=self._held)
                        if draft is not None else None)

    def _held(self, *_args) -> list:
        return [*self.model.parameters(), self.kcache, self.vcache]

    def _forward(self, tokens, offsets, num_valid, table) -> torch.Tensor:
        return D.forward_paged(self.spec, self.model, tokens, offsets,
                               num_valid, table, self.kcache, self.vcache)

    def _verify_program(self, tok, lengths, num_valid, table):
        logits = self._forward(tok, lengths, num_valid, table)
        return D.speculative_accept(logits, tok[:, 1:])

    def memory_programs(self) -> dict:
        """Label -> ``probe.TrackedProgram`` (JAX ``memory_programs``): the
        decode step and the prefill (one row per bucket run), or the chunk
        program under chunked prefill when no bucket ran; a speculative
        pair has ``verify`` in place of the decode step, which never
        runs, and the draft's programs under ``draft_``."""
        out = {"decode_step": self._decode, "prefill": self._prefill}
        if self._chunk is not None:
            out["prefill_chunk"] = self._chunk
            if not self.compiled_buckets:
                del out["prefill"]
        if self.draft is not None:
            out["verify"] = self._verify
            del out["decode_step"]
            out.update({f"draft_{k}": v
                        for k, v in self.draft.memory_programs().items()})
        return out

    def _check_pair(self) -> None:
        """The JAX engine's pairing checks (``engine.py:439-494``): a bad
        pair fails at construction with its reason, never mid-run."""
        draft = self.draft
        if (draft is None) != (self.spec_tokens == 0):
            raise ValueError(
                "speculative decoding needs BOTH a draft engine and "
                "spec_tokens >= 1 (--serve_draft_ckpt + "
                "--serve_spec_tokens): the draft proposes, spec_tokens "
                "sizes the verify program — one without the other is "
                "inert")
        if draft is None:
            return
        if self.spec_tokens < 1:
            raise ValueError(
                f"spec_tokens must be >= 1, got {self.spec_tokens}")
        if draft.spec.vocab != self.spec.vocab:
            raise ValueError(
                f"draft/target vocabulary mismatch ({draft.spec.vocab} vs "
                f"{self.spec.vocab}): the draft proposes TOKEN IDS that the "
                "target's verify logits score — the two models must share "
                "one id space")
        if draft.spec.num_experts:
            raise ValueError(
                "MoE draft model rejected: the serving MoE decode computes "
                "EVERY expert's FFN densely and combines by the top-1 gate "
                "(models/decode._moe_ffn), so an MoE draft costs more per "
                "step than its dense twin of the same hidden size — a draft "
                "exists to be cheap; use a dense draft checkpoint")
        if draft.draft is not None:
            raise ValueError("draft engines cannot nest: the draft of a "
                             "pair must be a plain engine")
        mismatch = [(n, getattr(draft, n), getattr(self, n))
                    for n in ("max_batch", "page_size", "max_seq",
                              "prompt_buckets", "prefill_chunk",
                              "prefix_cache")
                    if getattr(draft, n) != getattr(self, n)]
        if draft.allocator.max_pages != self.allocator.max_pages:
            mismatch.append(("max_pages", draft.allocator.max_pages,
                             self.allocator.max_pages))
        if mismatch:
            raise ValueError(
                "draft/target engine geometry must match so the two page "
                "pools stay position-for-position paired (one page table "
                "schedule, joint admission): mismatched "
                + ", ".join(f"{n} ({a} vs {b})" for n, a, b in mismatch))

    # -- construction from a sharded checkpoint ------------------------
    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, *, model=None, device=None,
                        **engine_kw) -> "ServeEngine":
        """The engine off a checkpoint root or one committed ``ckpt_<E>``
        directory: the architecture from the manifest metadata (``model=``
        only for metadata-less checkpoints), worker 0's params (a resident
        checkpoint's consensus) streamed onto ``device`` (default: the
        card)."""
        path = resolve_checkpoint(ckpt_dir)
        meta = ckpt_lib.manifest_metadata(path)
        if device is None:
            from ..mesh import worker_device
            device = worker_device(0, None)
        if model is None:
            if not meta:
                raise ValueError(
                    f"checkpoint {path} carries no serve metadata (saved "
                    "by a pre-metadata engine?) — pass model= explicitly")
            model = model_from_metadata(meta, device)
        load_params_row0(path, model)
        log.info("serve: restored %s params from %s onto %s",
                 meta.get("model") or type(model).__name__, path,
                 next(model.parameters()).device)
        return cls(model, **engine_kw)

    # -- page math -----------------------------------------------------
    def pages_for(self, total_tokens: int) -> int:
        return pages_needed(total_tokens, self.page_size)

    def page_bytes(self) -> int:
        """Bytes one page pins across both pools and every layer."""
        itemsize = torch.empty((), dtype=self.spec.dtype).element_size()
        return (2 * self.spec.num_layers * self.page_size
                * self.spec.num_kv_heads * self.spec.head_dim * itemsize)

    def table_row(self, pages: list[int]) -> np.ndarray:
        return page_table_row(pages, self.pages_per_seq)

    # -- the programs --------------------------------------------------
    def _dispatch(self, program: str, shape: tuple, want: tuple) -> None:
        if tuple(shape) != tuple(want):
            raise ValueError(f"{program} takes shape {want}, got {shape}")
        self.programs.add((program, tuple(int(d) for d in want)))

    def _tensor(self, a, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device, dtype)

    @torch.inference_mode()
    def _span(self, program, tokens: np.ndarray, nvalid: int, offset: int,
              page_row: np.ndarray, temperature: float, rid: int
              ) -> tuple[int, torch.Tensor]:
        """Prefill ``nvalid`` tokens of ``tokens [1, T]`` at cache position
        ``offset`` through ``program``; the token is drawn at position
        ``offset + nvalid``, the first generated position when the span
        ends the prompt."""
        logits = program(
            self._tensor(tokens), self._tensor([offset]),
            self._tensor([nvalid]), self._tensor(page_row[None]))
        last = logits[0, nvalid - 1]
        nxt = D.sample_tokens(last[None], [temperature], [rid],
                              [offset + nvalid], self.seed)
        return int(nxt[0]), last

    def prefill(self, prompt, page_row: np.ndarray, temperature: float,
                rid: int, *, offset: int = 0) -> tuple[int, torch.Tensor]:
        """One prompt span through the prefill program at its bucket shape
        from cache position ``offset``; returns (first sampled token, the
        last position's logits on the device)."""
        prompt = np.asarray(prompt, np.int32)
        plen = int(prompt.shape[0])
        bucket = pick_bucket(plen, self.prompt_buckets)
        if bucket not in self.compiled_buckets:
            self.compiled_buckets.append(bucket)
        padded = pad_to_bucket(prompt, bucket)[None]
        self._dispatch("prefill", padded.shape, (1, bucket))
        return self._span(self._prefill, padded, plen, offset, page_row,
                          temperature, rid)

    def prefill_chunk_step(self, chunk, offset: int, page_row: np.ndarray,
                           temperature: float, rid: int
                           ) -> tuple[int, torch.Tensor]:
        """Advance one prompt by one ``[1, prefill_chunk]`` chunk at cache
        position ``offset``; the final chunk's token is drawn where the
        monolithic prefill draws it."""
        if not self.prefill_chunk:
            raise RuntimeError("engine built without prefill_chunk")
        chunk = np.asarray(chunk, np.int32)
        nvalid = int(chunk.shape[0])
        if not 0 < nvalid <= self.prefill_chunk:
            raise ValueError(
                f"chunk of {nvalid} tokens outside (0, "
                f"{self.prefill_chunk}]")
        padded = pad_to_bucket(chunk, self.prefill_chunk)[None]
        self._dispatch("prefill_chunk", padded.shape,
                       (1, self.prefill_chunk))
        return self._span(self._chunk, padded, nvalid, offset, page_row,
                          temperature, rid)

    @torch.inference_mode()
    def decode(self, tokens, lengths, page_table, temps, rids, active
               ) -> tuple[np.ndarray, torch.Tensor]:
        """One batched decode step at the ``[max_batch, 1]`` shape; rows
        with ``active == 0`` write to the trash page and their outputs are
        meaningless.  Returns (next tokens [B] on the host, logits
        [B, vocab] on the device)."""
        tokens = np.asarray(tokens, np.int32)
        lengths = np.asarray(lengths, np.int32)
        self._dispatch("decode", (*tokens.shape, 1), (self.max_batch, 1))
        logits = self._decode(
            self._tensor(tokens[:, None]), self._tensor(lengths),
            self._tensor(np.asarray(active, np.int32)),
            self._tensor(page_table))[:, 0]
        nxt = D.sample_tokens(logits, temps, rids, lengths + 1, self.seed)
        return nxt.cpu().numpy(), logits

    @torch.inference_mode()
    def verify(self, tokens, lengths, page_table, active
               ) -> tuple[np.ndarray, np.ndarray]:
        """Score one speculation burst: ``tokens [max_batch, k+1]`` (the
        pending token and k draft proposals per row) at cache offsets
        ``lengths``; writes the target's keys and values for positions
        ``C .. C+k`` (inactive rows to the trash page) and returns the
        accept verdict ``(emitted [B, k], acc [B])`` on the host: row i
        commits ``emitted[i, :acc[i] + 1]``.  Greedy only (the config and
        the scheduler refuse temperature with a draft)."""
        if self.draft is None:
            raise RuntimeError("engine built without a draft pair")
        k = self.spec_tokens
        tokens = np.asarray(tokens, np.int32)
        self._dispatch("verify", tokens.shape, (self.max_batch, k + 1))
        active = self._tensor(np.asarray(active, bool), torch.bool)
        num_valid = torch.where(active, k + 1, 0)
        emitted, acc = self._verify(self._tensor(tokens),
                                    self._tensor(lengths), num_valid,
                                    self._tensor(page_table))
        out = torch.cat([emitted, acc[:, None]], 1).cpu().numpy()
        return out[:, :k], out[:, k]
