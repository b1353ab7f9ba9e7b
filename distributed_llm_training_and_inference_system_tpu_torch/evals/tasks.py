"""Standard-format task evaluation (the JAX package's ``evals/tasks.py``):
multiple choice by summed log-likelihood, greedy-match QA.

## Task file schema (JSONL, one example per line)

Multiple choice (scored by conditional log-likelihood of each choice
continuation; reports raw and length-normalised accuracy):

    {"type": "multiple_choice",
     "context": [12, 53, 9, ...],        # token ids (or "context_text")
     "choices": [[4, 2], [7], [1, 1, 3]],
     "answer": 0}

Greedy match (the model must greedily decode the exact target
continuation; reports exact-match accuracy and mean matched-prefix
fraction):

    {"type": "greedy_match",
     "context": [12, 53, 9, ...],
     "target": [4, 2, 19]}

``context_text`` / ``choices_text`` / ``target_text`` are tokenized with
``serve.tokenizer.load_tokenizer``. Blank lines and ``#`` comments are
skipped; a schema violation raises ValueError with its line number.

Rows are right-padded to the JAX package's power-of-two length buckets and
scored in batches sorted by bucket, with the original order restored. Each
batch is one dense ``models.gpt.forward`` under ``torch.no_grad()`` (plain
attention, on the model's device), ``log_softmax`` in fp32, gathered at
the continuation positions, masked and summed.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from ..models import gpt


@dataclass
class TaskExample:
    type: str                               # multiple_choice | greedy_match
    context: list[int]
    choices: list[list[int]] = field(default_factory=list)
    answer: int = 0
    target: list[int] = field(default_factory=list)


def _tokenize_fields(d: dict, tokenizer) -> dict:
    """Resolve *_text fields into token ids (on a copy)."""
    d = dict(d)
    if "context" not in d and "context_text" in d:
        d["context"] = tokenizer.encode(d["context_text"])
    if "choices" not in d and "choices_text" in d:
        d["choices"] = [tokenizer.encode(c) for c in d["choices_text"]]
    if "target" not in d and "target_text" in d:
        d["target"] = tokenizer.encode(d["target_text"])
    return d


def load_task_file(path: str | Path, tokenizer=None) -> list[TaskExample]:
    """Parse a JSONL task file; raises ValueError with the offending line
    number on schema violations (a skipped example would bias the
    reported accuracy)."""
    examples = []
    for lineno, line in enumerate(Path(path).read_text().splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            d = json.loads(line)
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}:{lineno}: invalid JSON: {e}") from e
        if any(k.endswith("_text") for k in d):
            if tokenizer is None:
                from ..serve.tokenizer import load_tokenizer
                tokenizer = load_tokenizer(None, vocab_size=1 << 30)
            d = _tokenize_fields(d, tokenizer)
        t = d.get("type")
        if t == "multiple_choice":
            if not d.get("choices") or "answer" not in d:
                raise ValueError(f"{path}:{lineno}: multiple_choice needs "
                                 "'choices' and 'answer'")
            if not 0 <= d["answer"] < len(d["choices"]):
                raise ValueError(f"{path}:{lineno}: answer index "
                                 f"{d['answer']} out of range")
            examples.append(TaskExample(
                type=t, context=[int(x) for x in d["context"]],
                choices=[[int(x) for x in c] for c in d["choices"]],
                answer=int(d["answer"])))
        elif t == "greedy_match":
            if not d.get("target"):
                raise ValueError(f"{path}:{lineno}: greedy_match needs "
                                 "'target'")
            examples.append(TaskExample(
                type=t, context=[int(x) for x in d["context"]],
                target=[int(x) for x in d["target"]]))
        else:
            raise ValueError(f"{path}:{lineno}: unknown task type {t!r}")
    if not examples:
        raise ValueError(f"{path}: no examples")
    return examples


def _bucket(n: int, lo: int = 32) -> int:
    b = lo
    while b < n:
        b <<= 1
    return b


@torch.no_grad()
def _score(params, cfg, toks: torch.Tensor, start: torch.Tensor,
           length: torch.Tensor) -> torch.Tensor:
    """[B] summed log p of each row's continuation tokens."""
    logits = gpt.forward(params, toks, cfg)
    logp = torch.log_softmax(logits.float(), dim=-1)
    S = toks.shape[1]
    pos = torch.arange(S, device=toks.device)[None, :]
    tgt = torch.roll(toks, -1, dims=1)                # tgt[i] = toks[i+1]
    per = torch.gather(logp, -1, tgt[..., None])[..., 0]
    mask = (pos >= start[:, None] - 1) & (pos < (start + length)[:, None] - 1)
    return torch.sum(per * mask, dim=1)


def _continuation_logprobs(params, cfg, rows: list[tuple[list[int],
                                                         list[int]]],
                           batch_size: int = 16) -> list[float]:
    """Summed log p(continuation | context) for each (context, cont) row.

    One dense forward per padded batch; positions are scored where the
    model PREDICTS the continuation token (logits index ctx+j-1).
    """
    dev = params.device
    out: list[tuple[int, float]] = []
    order = sorted(range(len(rows)),
                   key=lambda i: _bucket(len(rows[i][0]) + len(rows[i][1])))
    for i0 in range(0, len(order), batch_size):
        chunk = order[i0:i0 + batch_size]
        B = _bucket(max(len(rows[i][0]) + len(rows[i][1]) for i in chunk))
        toks = np.zeros((len(chunk), B), np.int64)
        start = np.zeros(len(chunk), np.int64)
        length = np.zeros(len(chunk), np.int64)
        for j, i in enumerate(chunk):
            ctx, cont = rows[i]
            seq = ctx + cont
            toks[j, :len(seq)] = seq
            start[j], length[j] = len(ctx), len(cont)
        s = _score(params, cfg, torch.from_numpy(toks).to(dev),
                   torch.from_numpy(start).to(dev),
                   torch.from_numpy(length).to(dev))
        out.extend(zip(chunk, s.cpu().tolist()))
    out.sort(key=lambda t: t[0])
    return [s for _, s in out]


def score_multiple_choice(params, cfg, examples: Sequence[TaskExample],
                          batch_size: int = 16) -> dict:
    """Accuracy (summed ll) + length-normalized accuracy (ll / len)."""
    mc = [e for e in examples if e.type == "multiple_choice"]
    if not mc:
        return {}
    rows, spans = [], []
    for e in mc:
        spans.append((len(rows), len(e.choices)))
        rows.extend((e.context, c) for c in e.choices)
    lls = _continuation_logprobs(params, cfg, rows, batch_size)
    correct = correct_norm = 0
    for e, (off, k) in zip(mc, spans):
        scores = lls[off:off + k]
        norm = [s / max(len(c), 1) for s, c in zip(scores, e.choices)]
        correct += int(int(np.argmax(scores)) == e.answer)
        correct_norm += int(int(np.argmax(norm)) == e.answer)
    return {
        "examples": len(mc),
        "acc": correct / len(mc),
        "acc_norm": correct_norm / len(mc),
    }


@torch.no_grad()
def _next_tok(params, cfg, toks: torch.Tensor,
              length: torch.Tensor) -> torch.Tensor:
    """[B] greedy token after each row's first ``length`` tokens."""
    logits = gpt.forward(params, toks, cfg)
    idx = torch.clamp(length - 1, min=0)
    rows = logits[torch.arange(toks.shape[0], device=toks.device), idx]
    return torch.argmax(rows, dim=-1)


def greedy_continuations(params, cfg, examples: Sequence[TaskExample],
                         batch_size: int = 16) -> list[list[int]]:
    """The greedy decode of len(target) tokens from each greedy_match
    example's context, in order. Each step recomputes the full prefix
    (dense forward): eval is offline, the serving engine is the fast
    path."""
    dev = params.device
    gm = [e for e in examples if e.type == "greedy_match"]
    results: list[list[int]] = []
    for i0 in range(0, len(gm), batch_size):
        chunk = gm[i0:i0 + batch_size]
        T = max(len(e.target) for e in chunk)
        B = _bucket(max(len(e.context) for e in chunk) + T)
        toks = np.zeros((len(chunk), B), np.int64)
        length = np.zeros(len(chunk), np.int64)
        for j, e in enumerate(chunk):
            toks[j, :len(e.context)] = e.context
            length[j] = len(e.context)
        outs: list[list[int]] = [[] for _ in chunk]
        for _ in range(T):
            nxt = _next_tok(params, cfg, torch.from_numpy(toks).to(dev),
                            torch.from_numpy(length).to(dev)).cpu().numpy()
            for j in range(len(chunk)):
                if len(outs[j]) < len(chunk[j].target):
                    outs[j].append(int(nxt[j]))
                    toks[j, length[j]] = int(nxt[j])
                    length[j] += 1
        results.extend(outs)
    return results


def score_greedy_match(params, cfg, examples: Sequence[TaskExample],
                       batch_size: int = 16) -> dict:
    """Greedy-decode len(target) tokens from each context; exact match +
    mean matched-prefix fraction."""
    gm = [e for e in examples if e.type == "greedy_match"]
    if not gm:
        return {}
    exact = 0
    prefix_frac = 0.0
    for e, o in zip(gm, greedy_continuations(params, cfg, gm, batch_size)):
        match = 0
        for a, b in zip(o, e.target):
            if a != b:
                break
            match += 1
        exact += int(match == len(e.target))
        prefix_frac += match / len(e.target)
    return {
        "examples": len(gm),
        "exact_match": exact / len(gm),
        "prefix_match": prefix_frac / len(gm),
    }


def run_tasks(params, cfg, path: str | Path, tokenizer=None,
              batch_size: int = 16) -> dict:
    """Score one task file; returns {file, n, multiple_choice?, greedy?}."""
    examples = load_task_file(path, tokenizer)
    out: dict[str, Any] = {"file": str(path), "examples": len(examples)}
    mc = score_multiple_choice(params, cfg, examples, batch_size)
    if mc:
        out["multiple_choice"] = mc
    gm = score_greedy_match(params, cfg, examples, batch_size)
    if gm:
        out["greedy_match"] = gm
    return out
