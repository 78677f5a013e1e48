"""Drafters for speculative decoding in the resident pool.

The port's own copy of the JAX package's ``serving/spec.py`` (numpy only).
Speculative decoding splits every emitted token into *draft* (cheap guess)
and *verify* (one real forward). The scheduler owns the verify side — ONE
multi-token decode step over all slots
(:meth:`repro_torch.serving.scheduler.ContinuousBatchingScheduler.step`);
this module owns the draft side: per-slot host state that proposes ``k``
candidate continuation tokens per tick. Drafters are pure host objects —
no parameters, no device tensors.

Drafter protocol (duck-typed — any object with these three methods):

``begin(tokens) -> state``
    Per-slot draft state from the request's prompt plus its first emitted
    token. Called at admission; dropped at retirement.
``draft(state, k) -> np.ndarray  # (k,) int32``
    Propose the next ``k`` tokens. Always returns exactly ``k`` entries —
    pad with a repeat when the heuristic has nothing better; a padded
    guess that fails verification just yields accept-length 0.
``update(state, tokens) -> None``
    Observe the tokens the verify step actually emitted.

The stock drafter is :class:`NGramDrafter` — prompt+output n-gram lookup:
find the most recent earlier occurrence of the trailing n-gram of (prompt
++ emitted output) and propose the tokens that followed it.
"""
from __future__ import annotations

import numpy as np


class NGramDrafter:
    """Prompt+output n-gram lookup drafter.

    ``draft`` scans the slot's token history (prompt + emitted tokens) for
    the most recent earlier occurrence of its trailing n-gram, longest
    ``n`` first (``max_ngram`` down to ``min_ngram``), and proposes the
    ``k`` tokens that followed that occurrence. No match ⇒ repeat the last
    token (a period-1 guess; wrong guesses cost nothing but the fallback
    one-token tick). State per slot is a plain list of ints.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def begin(self, tokens) -> list:
        return [int(t) for t in np.asarray(tokens).reshape(-1)]

    def draft(self, state: list, k: int) -> np.ndarray:
        n_hist = len(state)
        hi = min(self.max_ngram, n_hist - 1)
        for n in range(hi, self.min_ngram - 1, -1):
            pat = state[-n:]
            for i in range(n_hist - n - 1, -1, -1):
                if state[i : i + n] == pat:
                    cont = state[i + n : i + n + k]
                    out = np.empty(k, np.int32)
                    out[: len(cont)] = cont
                    out[len(cont) :] = cont[-1]
                    return out
        return np.full(k, state[-1] if state else 0, np.int32)

    def update(self, state: list, tokens) -> None:
        state.extend(int(t) for t in np.asarray(tokens).reshape(-1))


class ScriptedDrafter:
    """Drafter that makes each verify tick accept a chosen number of drafts.

    ``plans`` maps a prompt (tuple of ints) to the request's known
    continuation — the ``n_new`` tokens a standalone ``generate`` emits with
    the same seed, its first token included. Tick ``t`` proposes the true
    tokens for the first ``accepts[t]`` draft positions (the schedule's last
    entry repeats) and a wrong token after them, so a lossless verify
    accepts exactly that many, clamped at the request's tail. ``log``
    records one ``(planned, emitted, remaining)`` triple per tick, so a test
    can check full, partial and zero accepts all happened as planned.
    """

    def __init__(self, plans: dict, accepts, vocab: int):
        self.plans = {tuple(int(t) for t in k): [int(t) for t in v] for k, v in plans.items()}
        self.accepts = list(accepts)
        self.vocab = vocab
        self.log: list = []

    def begin(self, tokens) -> dict:
        prompt = tuple(int(t) for t in np.asarray(tokens).reshape(-1)[:-1])  # + first token
        return {"ref": self.plans[prompt], "n": 1, "tick": 0}

    def draft(self, state: dict, k: int) -> np.ndarray:
        ref, n = state["ref"], state["n"]
        a = self.accepts[min(state["tick"], len(self.accepts) - 1)]
        state["tick"] += 1
        state["planned"] = a
        true = [ref[n + i] if n + i < len(ref) else 0 for i in range(k)]
        return np.array([t if i < a else (t + 1) % self.vocab for i, t in enumerate(true)], np.int32)

    def update(self, state: dict, tokens) -> None:
        emitted = len(np.asarray(tokens).reshape(-1))
        self.log.append((state["planned"], emitted, len(state["ref"]) - state["n"]))
        state["n"] += emitted

    def summary(self, k: int) -> dict:
        """Counts of the logged ticks: ``as_planned`` is False if any tick
        emitted other than ``min(planned + 1, remaining)`` tokens; ``full``,
        ``partial`` and ``zero`` count ticks not clamped by the tail that
        accepted all ``k``, some, or none of their drafts."""
        free = [(p, e) for p, e, r in self.log if r > p + 1]
        return {
            "ticks": len(self.log),
            "as_planned": all(e == min(p + 1, r) for p, e, r in self.log),
            "full": sum(p == k for p, _ in free),
            "partial": sum(0 < p < k for p, _ in free),
            "zero": sum(p == 0 for p, _ in free),
        }


def resolve_drafter(drafter):
    """Scheduler knob → drafter instance: None/'ngram' ⇒ the stock
    :class:`NGramDrafter`; anything else must already implement the
    drafter protocol (begin/draft/update) and is used as-is."""
    if drafter is None or drafter == "ngram":
        return NGramDrafter()
    for m in ("begin", "draft", "update"):
        if not callable(getattr(drafter, m, None)):
            raise ValueError(
                f"drafter must implement begin/draft/update (missing {m!r})"
            )
    return drafter
