"""The port's task evaluation against the JAX package's ``evals.tasks``
(gpt-test, fp32, CPU, JAX-initialised params carried across).

- Summed continuation log-likelihoods within 1e-5 (absolute) of JAX's,
  plus two fp32 ulps of the sum (a 20-token continuation sums to -112,
  where one ulp is 7.6e-6 and the two packages reduce in another order),
  across padding buckets and batch orders.
- ``acc``, ``acc_norm``, ``exact_match`` and ``prefix_match`` equal, and so
  are the greedy continuations.
- Bad answer indices, unknown types and invalid JSON raise JAX's exception
  types with the same line numbers; comments and blank lines are skipped
  as JAX skips them; text fields tokenize alike.
"""

import json

import jax
import numpy as np
import pytest

from distributed_llm_training_and_inference_system_tpu.config import (
    get_model_config as jax_cfg)
from distributed_llm_training_and_inference_system_tpu.evals import (
    tasks as jtasks)
from distributed_llm_training_and_inference_system_tpu.models import (
    gpt as jgpt)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    get_model_config as torch_cfg)
from distributed_llm_training_and_inference_system_tpu_torch.evals import (
    tasks as ttasks)
from distributed_llm_training_and_inference_system_tpu_torch.weights import (
    params_from_jax)

LL_ATOL = 1e-5
LL_RTOL = 2 * 2.0 ** -23          # two fp32 ulps of the summed value


@pytest.fixture(scope="module")
def models():
    jc, tc = jax_cfg("gpt-test"), torch_cfg("gpt-test")
    jp = jgpt.init(jc, jax.random.PRNGKey(0))
    return jp, jc, params_from_jax(jp, tc, device="cpu"), tc


def write_jsonl(tmp_path, rows, name="tasks.jsonl"):
    p = tmp_path / name
    p.write_text("\n".join(r if isinstance(r, str) else json.dumps(r)
                           for r in rows))
    return p


def _rows(seed, shapes, vocab=256):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, c).tolist(),
             rng.integers(1, vocab, n).tolist()) for c, n in shapes]


@pytest.mark.parametrize("batch_size", [1, 2, 16])
def test_continuation_logprobs_equal_jax(models, batch_size):
    jp, jc, tp, tc = models
    # lengths across the 32/64/128 buckets, out of bucket order
    rows = _rows(0, [(3, 2), (70, 5), (40, 3), (7, 1), (30, 2), (1, 4),
                     (100, 20), (12, 12)])
    want = jtasks._continuation_logprobs(jp, jc, rows, batch_size)
    got = ttasks._continuation_logprobs(tp, tc, rows, batch_size)
    np.testing.assert_allclose(got, want, rtol=LL_RTOL, atol=LL_ATOL)


def _mc_examples(seed, n, vocab=256):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(2, 5))
        out.append(jtasks.TaskExample(
            type="multiple_choice",
            context=rng.integers(1, vocab, int(rng.integers(1, 40))).tolist(),
            choices=[rng.integers(1, vocab, int(rng.integers(1, 6))).tolist()
                     for _ in range(k)],
            answer=int(rng.integers(0, k))))
    return out


def _port(examples):
    return [ttasks.TaskExample(**vars(e)) for e in examples]


def test_multiple_choice_scores_equal_jax(models):
    jp, jc, tp, tc = models
    ex = _mc_examples(1, 12)
    want = jtasks.score_multiple_choice(jp, jc, ex, batch_size=4)
    got = ttasks.score_multiple_choice(tp, tc, _port(ex), batch_size=4)
    assert got == want
    assert 0.0 < got["acc"] < 1.0


def _greedy_examples(jp, jc, seed, n):
    """Greedy targets: half the model's own continuation (exact), half
    with one token changed (a prefix match)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ctx = rng.integers(1, 256, int(rng.integers(2, 30))).tolist()
        tgt = [int(rng.integers(1, 256)) for _ in range(int(rng.integers(1,
                                                                         6)))]
        out.append(jtasks.TaskExample(type="greedy_match", context=ctx,
                                      target=tgt))
    own = [jtasks.TaskExample(type="greedy_match", context=e.context,
                              target=e.target) for e in out]
    conts = ttasks.greedy_continuations(
        params_from_jax(jp, torch_cfg("gpt-test"), device="cpu"),
        torch_cfg("gpt-test"), _port(own))
    for e, c in zip(out[: n // 2], conts[: n // 2]):
        e.target = list(c)
    e = out[0]
    if len(e.target) > 1:
        out.append(jtasks.TaskExample(
            type="greedy_match", context=e.context,
            target=e.target[:1] + [(e.target[1] + 1) % 256] + e.target[2:]))
    return out


def test_greedy_continuations_and_scores_equal_jax(models):
    jp, jc, tp, tc = models
    ex = _greedy_examples(jp, jc, 2, 8)
    conts = ttasks.greedy_continuations(tp, tc, _port(ex), batch_size=3)
    # JAX's greedy decode, one row padded to 64 (causal: the pad is unseen)
    fwd = jax.jit(lambda t: jgpt.forward(jp, t, jc))
    for e, c in zip(ex, conts):
        toks = list(e.context)
        for _ in range(len(e.target)):
            row = np.zeros((1, 64), np.int32)
            row[0, :len(toks)] = toks
            logits = np.asarray(fwd(row))
            toks.append(int(np.argmax(logits[0, len(toks) - 1])))
        assert c == toks[len(e.context):]
    want = jtasks.score_greedy_match(jp, jc, ex, batch_size=3)
    got = ttasks.score_greedy_match(tp, tc, _port(ex), batch_size=3)
    assert got == want
    assert 0.0 < got["exact_match"] < 1.0


def test_run_tasks_mixed_file_equals_jax(models, tmp_path):
    jp, jc, tp, tc = models
    p = write_jsonl(tmp_path, [
        "# a mixed file",
        {"type": "multiple_choice", "context": [1, 2, 3],
         "choices": [[4], [5, 6]], "answer": 1},
        "",
        {"type": "greedy_match", "context": [9, 9, 9], "target": [1, 2]},
        {"type": "multiple_choice", "context_text": "ab",
         "choices_text": ["c", "dd"], "answer": 0},
        {"type": "greedy_match", "context_text": "xy", "target_text": "z"},
    ])
    want = jtasks.run_tasks(jp, jc, p)
    got = ttasks.run_tasks(tp, tc, p)
    assert got == want
    assert got["examples"] == 4


BAD = [
    ([{"type": "multiple_choice", "context": [1], "choices": [[2]],
       "answer": 3}], "out of range"),
    (["# c", "", {"type": "multiple_choice", "context": [1],
                  "choices": [[2]], "answer": -1}], "out of range"),
    ([{"type": "essay", "context": [1]}], "unknown task type"),
    (['{"type": "multiple_choice"', "not json"], "invalid JSON"),
    (["# only", {"type": "greedy_match", "context": [1], "target": [2]},
      "{broken"], "invalid JSON"),
    ([{"type": "multiple_choice", "context": [1]}], "needs 'choices'"),
    ([{"type": "greedy_match", "context": [1], "target": []}],
     "needs 'target'"),
    (["# nothing", ""], "no examples"),
]


@pytest.mark.parametrize("rows,what", BAD, ids=[
    "answer_index", "negative_answer_after_comment", "unknown_type",
    "invalid_json", "invalid_json_line_3", "no_choices", "no_target",
    "empty"])
def test_bad_files_raise_jax_errors(tmp_path, rows, what):
    p = write_jsonl(tmp_path, rows, name="bad.jsonl")
    with pytest.raises(ValueError, match=what) as je:
        jtasks.load_task_file(p)
    with pytest.raises(ValueError, match=what) as te:
        ttasks.load_task_file(p)
    assert type(te.value) is type(je.value)
    head = str(je.value).split(": ", 1)[0]          # path:line
    assert str(te.value).split(": ", 1)[0] == head


def test_good_files_load_alike(tmp_path):
    p = write_jsonl(tmp_path, [
        "# header", "",
        {"type": "greedy_match", "context_text": "ab", "target_text": "c"},
        "   ",
        {"type": "multiple_choice", "context": [1, 2],
         "choices": [[3], [4, 5]], "answer": 1},
    ])
    want = [vars(e) for e in jtasks.load_task_file(p)]
    assert [vars(e) for e in ttasks.load_task_file(p)] == want
    assert want[0]["context"] == [97, 98] and want[0]["target"] == [99]


def test_buckets_equal_jax():
    for n in (0, 1, 31, 32, 33, 64, 65, 1000, 4097):
        assert ttasks._bucket(n) == jtasks._bucket(n)
        assert ttasks._bucket(n, lo=8) == jtasks._bucket(n, lo=8)
