"""The port's paged decode (``..._torch/models/decode.py``) against the JAX
package's ``models/decode.py`` on the same parameters (converted by
``weights.flax_to_torch``), for gpt, llama, llama with grouped-query
attention and gpt with Switch experts, in fp32 (the only compute dtype the
JAX decode traces): a prefill of two prompts (one padded inside its
bucket) and 8 batched decode steps, each fed the JAX argmax tokens, give
logits within atol 1e-5 with equal argmax, and the page pools agree
(outside the trash page) after all of it."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learning_deep_neural_network_in_distributed_computing_environment_tpu.models import (
    decode as JD,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu.models import (
    get_model as j_get_model,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch import (
    weights,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models import (
    decode as TD,
)
from learning_deep_neural_network_in_distributed_computing_environment_tpu_torch.models import (
    get_model,
)
from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

VOCAB = 97
PROMPTS = [[5, 9, 3, 7, 2, 11, 4, 1], [8, 6, 33, 2, 90]]
FAMILIES = {
    "gpt": ("gpt_tiny", {}),
    "llama": ("llama_tiny", {}),
    "llama_gqa": ("llama_tiny", {"num_kv_heads": 2}),
    "gpt_moe": ("gpt_tiny", {"num_experts": 2, "capacity_factor": 2.0}),
}
PAGE, PAGES, PER_SEQ = 4, 12, 5
TABLES = np.array([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]], np.int32)
ATOL = 1e-5
STEPS = 8


def _pair(fam):
    """The JAX model's params and the port model holding the same values."""
    name, kw = FAMILIES[fam]
    jm = j_get_model(name, num_classes=VOCAB, scan_layers=True, **kw)
    params = jm.init(jax.random.key(0),
                     np.asarray(PROMPTS[0], np.int32)[None])["params"]
    tm = get_model(name, num_classes=VOCAB, dtype=torch.float32, **kw)
    tm.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in weights.flax_to_torch(params).items()})
    return jm, params, tm.eval()


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_forward_paged_matches_jax(fam):
    jm, params, tm = _pair(fam)
    jspec, tspec = JD.spec_from_model(jm), TD.spec_from_model(tm)
    assert (tspec.num_layers, tspec.num_kv_heads, tspec.head_dim,
            tspec.vocab) == (jspec.num_layers, jspec.num_kv_heads,
                             jspec.head_dim, jspec.vocab)
    fwd = jax.jit(functools.partial(JD.forward_paged, jspec))
    jk, jv = JD.init_paged_cache(jspec, PAGES, PAGE)
    tk, tv = TD.init_paged_cache(tspec, PAGES, PAGE)
    t = lambda a: torch.as_tensor(np.asarray(a)).long()

    def both(tokens, lengths, num_valid, table):
        nonlocal jk, jv
        lg, jk, jv = fwd(params, jnp.asarray(tokens), jnp.asarray(lengths),
                         jnp.asarray(num_valid), jnp.asarray(table), jk, jv)
        with torch.no_grad():
            tl = TD.forward_paged(tspec, tm, t(tokens), t(lengths),
                                  t(num_valid), t(table), tk, tv)
        lg = np.asarray(lg)
        np.testing.assert_allclose(tl.numpy(), lg, rtol=0, atol=ATOL)
        np.testing.assert_array_equal(tl.numpy().argmax(-1), lg.argmax(-1))
        return lg

    last = []
    for i, prompt in enumerate(PROMPTS):       # prefill, bucket 8
        padded = np.zeros((1, 8), np.int32)
        padded[0, :len(prompt)] = prompt
        lg = both(padded, [0], [len(prompt)], TABLES[i:i + 1])
        last.append(int(lg[0, len(prompt) - 1].argmax()))
    lengths = np.array([len(p) for p in PROMPTS], np.int32)
    tokens = np.array(last, np.int32)
    for _ in range(STEPS):                     # batched decode [2, 1]
        lg = both(tokens[:, None], lengths, [1, 1], TABLES)
        tokens = lg[:, 0].argmax(-1).astype(np.int32)
        lengths = lengths + 1
    # the pools outside the trash page (padding rows scribble there)
    np.testing.assert_allclose(tk[:, 1:].numpy(), np.asarray(jk)[:, 1:],
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(tv[:, 1:].numpy(), np.asarray(jv)[:, 1:],
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("fam", ["gpt", "llama_gqa"])
def test_paged_prefill_matches_the_port_full_forward(fam):
    """The paged prefill computes what the port's own full-sequence forward
    does (fp32, atol 1e-5); incremental decode then continues it."""
    _, _, tm = _pair(fam)
    spec = TD.spec_from_model(tm)
    k, v = TD.init_paged_cache(spec, PAGES, PAGE)
    ids = torch.tensor([PROMPTS[0]])
    with torch.no_grad():
        full = tm(ids)
        lg = TD.forward_paged(spec, tm, ids[:, :5], torch.tensor([0]),
                              torch.tensor([5]), torch.tensor(TABLES[:1]),
                              k, v)
        steps = [lg]
        for i in range(5, 8):
            steps.append(TD.forward_paged(
                spec, tm, ids[:, i:i + 1], torch.tensor([i]),
                torch.tensor([1]), torch.tensor(TABLES[:1]), k, v))
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               rtol=0, atol=ATOL)


def test_spec_rejects_models_without_a_decode_path():
    with pytest.raises(ValueError, match="no decode path"):
        TD.spec_from_model(get_model("bert_tiny", num_classes=VOCAB))


def test_sampling_depends_on_seed_request_and_position_only():
    """Greedy is the argmax; a temperature row's draw is a function of
    (seed, rid, position) alone: the same row in another batch, at another
    slot, draws the same token."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(3, VOCAB, generator=g)
    temps = np.array([0.0, 0.8, 0.8], np.float32)
    out = TD.sample_tokens(logits, temps, [4, 5, 6], [9, 9, 12], seed=1)
    assert int(out[0]) == int(logits[0].argmax())
    alone = TD.sample_tokens(logits[2:3], temps[2:3], [6], [12], seed=1)
    assert int(alone[0]) == int(out[2])
    moved = TD.sample_tokens(logits[[2, 1]], temps[[2, 1]], [6, 5],
                             [12, 9], seed=1)
    assert moved.tolist() == [int(out[2]), int(out[1])]
    draws = {int(TD.sample_tokens(logits[1:2], temps[1:2], [5], [p],
                                  seed=1)[0]) for p in range(40)}
    assert len(draws) > 1            # the position moves the draw
