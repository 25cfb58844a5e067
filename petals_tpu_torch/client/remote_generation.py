"""Autoregressive generation against remote KV caches
(petals_tpu/client/remote_generation.py): greedy, temperature / top-k /
top-p sampling, beam search (HF BeamSearchScorer semantics), the HF logits
processors (repetition penalty, no-repeat n-grams, min_new_tokens), eos /
pad, streamers and stopping criteria, over the swarm session, with
multi-call reuse of one session.

The sampling loop, the penalties and beam scoring are numpy, as petals_tpu's
are (``:62-175``): each step moves its last position's float32 logits to
the host once. Seeded draws come from ``np.random.RandomState(seed)`` in
petals_tpu's order, so a port client and a petals_tpu client emit the same
seeded stream over the same servers on the per-token path.

The server-side fast paths (petals_tpu's ``generate`` :327-375): over a
route of one whole-model server that generates (``server_gen``), a batch-1
call with no logits processor, stopping criterion, n-gram ban or
``min_new_tokens`` asks the server for chunks of up to 32 tokens, one round
trip each (``_server_side_greedy``; sampling and the repetition penalty in
``_server_side_sample``, with the wire seed ``seed % 2**31``, or a random
one). A sampled stream draws by inverse-CDF from ``uniform_for_draw(seed,
i)``, petals_tpu's Threefry contract (ops/threefry.py), so a stream cut
mid-chunk is finished per token on the same draws.

Prompt tuning (client/ptune.py): a model with trained prompts prepends its
shallow prompts to the first feed of a session only, sizes the session for
them, and sends its deep prompts (or the caller's ``prompts``) with every
step; a stream with deep prompts keeps the per-token path, as petals_tpu's
does.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Optional

import numpy as np
import torch

from petals_tpu_torch.ops import threefry

logger = logging.getLogger(__name__)


def uniform_for_draw(seed: int, draw_index: int) -> float:
    """Draw ``draw_index`` of the server-side stream seeded ``seed``:
    ``jax.random.uniform(fold_in(PRNGKey(seed), draw_index))``, bit for bit
    (ops/threefry.py), as a server draws it."""
    return float(threefry.uniform_for_draw(int(seed), int(draw_index)))


def sample_next_token(
    logits: np.ndarray,  # [batch, vocab] float32
    *,
    do_sample: bool = False,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    rng: Optional[np.random.RandomState] = None,
    rng_key: Optional[tuple] = None,  # (seed, draw index): a server-side stream
) -> np.ndarray:
    """Pick the next token per row: argmax, or one draw per row from
    ``rng`` in row order, as petals_tpu's client draws, so a seeded port
    client and a seeded petals_tpu client emit the same stream.
    ``rng_key`` replays the server-side stream instead: every row draws by
    inverse-CDF against ``uniform_for_draw(*rng_key)``, as the server
    would have (its streams are batch 1)."""
    if not do_sample or temperature == 0.0:  # temperature->0 is greedy by convention
        return logits.argmax(axis=-1)

    logits = _warp_scores(logits, temperature=temperature, top_k=top_k, top_p=top_p)
    probs = _softmax(logits)
    out = np.empty(logits.shape[0], dtype=np.int64)
    if rng_key is not None:
        u = uniform_for_draw(*rng_key)
        for i in range(probs.shape[0]):
            out[i] = min(int((probs[i].cumsum() < u).sum()), probs.shape[-1] - 1)
        return out
    rng = rng or np.random
    for i in range(logits.shape[0]):
        out[i] = rng.choice(probs.shape[-1], p=probs[i])
    return out


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def apply_repetition_penalty(
    scores: np.ndarray, generated: np.ndarray, penalty: float
) -> np.ndarray:
    """HF RepetitionPenaltyLogitsProcessor: for every token already in the
    row's sequence, divide positive scores by ``penalty`` and multiply
    negative ones (works identically on raw logits and on logprobs)."""
    if penalty == 1.0:
        return scores
    scores = scores.copy()
    for row in range(scores.shape[0]):
        seen = np.unique(generated[row])
        vals = scores[row, seen]
        scores[row, seen] = np.where(vals > 0, vals / penalty, vals * penalty)
    return scores


def apply_no_repeat_ngram(
    scores: np.ndarray, generated: np.ndarray, ngram_size: int
) -> np.ndarray:
    """HF NoRepeatNGramLogitsProcessor: ban every token that would complete an
    n-gram already present in the row's sequence."""
    if ngram_size <= 0:
        return scores
    scores = scores.copy()
    cur_len = generated.shape[1]
    if cur_len + 1 < ngram_size:
        return scores
    for row in range(scores.shape[0]):
        seq = generated[row].tolist()
        prefix = tuple(seq[cur_len - ngram_size + 1 :])
        banned = [
            seq[i + ngram_size - 1]
            for i in range(cur_len - ngram_size + 1)
            if tuple(seq[i : i + ngram_size - 1]) == prefix
        ]
        if banned:
            scores[row, banned] = -np.inf
    return scores


def _process_scores(
    scores: np.ndarray,
    generated: np.ndarray,
    *,
    repetition_penalty: float = 1.0,
    no_repeat_ngram_size: int = 0,
    ban_eos_token_id: Optional[int] = None,
    logits_processor=None,
) -> np.ndarray:
    """HF logits-processor pipeline, in HF's order; ``ban_eos_token_id`` is
    the MinNewTokensLengthLogitsProcessor ban (pass it while the generated
    count is below min_new_tokens). ``logits_processor`` is the plug-in point
    for arbitrary HF-protocol processors — callables ``(input_ids, scores) ->
    scores`` over numpy arrays — applied after the built-ins, in list order
    (reference inherits this from transformers GenerationMixin)."""
    scores = apply_repetition_penalty(scores, generated, repetition_penalty)
    scores = apply_no_repeat_ngram(scores, generated, no_repeat_ngram_size)
    if ban_eos_token_id is not None:
        scores = scores.copy()
        scores[:, ban_eos_token_id] = -np.inf
    for proc in logits_processor or ():
        scores = np.asarray(proc(generated, scores))
    return scores


def _stop_requested(stopping_criteria, generated: np.ndarray, scores) -> bool:
    """HF stopping_criteria protocol: callables ``(input_ids, scores) ->
    bool | [batch] bool``. Per-row results are OR-ed ACROSS criteria and
    generation stops when every row is finished by some criterion (matching
    transformers, where the unfinished mask accumulates over the list)."""
    if not stopping_criteria:
        return False
    stopped = np.zeros(generated.shape[0], dtype=bool)
    for crit in stopping_criteria:
        stopped |= np.broadcast_to(np.asarray(crit(generated, scores), bool), stopped.shape)
        if stopped.all():
            return True
    return False


def _warp_scores(
    scores: np.ndarray,
    *,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
) -> np.ndarray:
    """HF logits-warper pipeline (temperature -> top_k -> top_p) used by beam
    sampling, where warping applies to the beam-score-added totals."""
    scores = scores.astype(np.float64)
    if temperature != 1.0 and temperature > 0:
        scores = scores / temperature
    if top_k is not None and top_k > 0:
        k = min(top_k, scores.shape[-1])
        kth = np.partition(scores, -k, axis=-1)[:, -k][:, None]
        scores = np.where(scores < kth, -np.inf, scores)
    if top_p is not None and top_p < 1.0:
        sorted_idx = np.argsort(-scores, axis=-1)
        sorted_scores = np.take_along_axis(scores, sorted_idx, axis=-1)
        probs = _softmax(sorted_scores)
        cumulative = probs.cumsum(axis=-1)
        cutoff = cumulative - probs > top_p
        sorted_scores[cutoff] = -np.inf
        restored = np.full_like(scores, -np.inf)
        np.put_along_axis(restored, sorted_idx, sorted_scores, axis=-1)
        scores = restored
    return scores


class RemoteGenerationMixin:
    """Requires: self.embed(ids) -> hidden tensor, self.lm_logits(hidden) ->
    float32 logits tensor, self.remote (RemoteSequential)."""

    _active_session = None

    def _embed_tokens(self, tokens) -> torch.Tensor:
        """Generated tokens' embeddings: never with the shallow prompts."""
        return self.embed(tokens, with_prompts=False)

    def _host_logits(self, out_hidden: torch.Tensor) -> np.ndarray:
        """The last position's float32 logits [batch, vocab], on the host."""
        return self.lm_logits(out_hidden[:, -1:])[:, 0].cpu().numpy()

    def inference_session(self, max_length: int, batch_size: int = 1):
        """Open a session that generate() picks up inside the block (the
        chat pattern)::

            with model.inference_session(max_length=128) as sess:
                out = model.generate(ids, max_new_tokens=8)      # uses sess
                out = model.generate(out, max_new_tokens=8)      # continues it
        """

        @contextlib.contextmanager
        def scope():
            session = self.remote.inference_session(max_length=max_length, batch_size=batch_size)
            previous = self._active_session
            self._active_session = session
            try:
                with session:
                    yield session
            finally:
                self._active_session = previous

        return scope()

    def generate(
        self,
        input_ids,  # [batch, seq] int
        *,
        max_new_tokens: int = 20,
        max_length: Optional[int] = None,
        do_sample: bool = False,
        num_beams: int = 1,
        temperature: float = 1.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        eos_token_id: Optional[int] = None,
        pad_token_id: Optional[int] = None,
        length_penalty: float = 1.0,
        early_stopping: bool = False,
        repetition_penalty: float = 1.0,
        no_repeat_ngram_size: int = 0,
        min_new_tokens: int = 0,
        num_return_sequences: int = 1,
        session=None,
        seed: Optional[int] = None,
        prompts=None,
        streamer=None,  # HF BaseStreamer protocol: .put(tokens), .end()
        logits_processor=None,  # HF protocol: [(input_ids, scores) -> scores]
        stopping_criteria=None,  # HF protocol: [(input_ids, scores) -> bool]
    ) -> np.ndarray:
        """Generated ids [batch * num_return_sequences, seq + new] (numpy
        int64), the prompt included."""
        if num_return_sequences < 1:
            raise ValueError("num_return_sequences must be >= 1")
        if num_return_sequences > 1 and num_beams == 1 and not do_sample:
            # HF raises the same way: greedy can only produce one sequence
            raise ValueError(
                "Greedy decoding can't return multiple sequences; set "
                "do_sample=True or num_beams >= num_return_sequences"
            )
        if num_beams > 1 and num_return_sequences > num_beams:
            raise ValueError("num_return_sequences must be <= num_beams")
        input_ids = np.asarray(input_ids)
        if max_length is not None:
            # HF semantics: max_length caps the TOTAL sequence length
            max_new_tokens = min(max_new_tokens, max_length - input_ids.shape[1])
        if num_beams > 1:
            if streamer is not None:
                raise ValueError("streamer is not supported with beam search (HF semantics)")
            return self._beam_search(
                input_ids,
                max_new_tokens=max_new_tokens,
                num_beams=num_beams,
                session=session if session is not None else self._active_session,
                prompts=prompts,
                do_sample=do_sample,
                temperature=temperature,
                top_k=top_k,
                top_p=top_p,
                seed=seed,
                eos_token_id=eos_token_id,
                pad_token_id=pad_token_id,
                length_penalty=length_penalty,
                early_stopping=early_stopping,
                repetition_penalty=repetition_penalty,
                no_repeat_ngram_size=no_repeat_ngram_size,
                min_new_tokens=min_new_tokens,
                num_return_sequences=num_return_sequences,
                logits_processor=logits_processor,
                stopping_criteria=stopping_criteria,
            )
        if num_return_sequences > 1:
            # HF sampling semantics: each return sequence is an independent
            # draw, so every batch row expands into num_return_sequences lanes
            input_ids = np.repeat(input_ids, num_return_sequences, axis=0)
            if prompts is not None:
                prompts = torch.repeat_interleave(torch.as_tensor(prompts).detach(), num_return_sequences, dim=1)
        batch, prompt_len = input_ids.shape
        rng = np.random.RandomState(seed) if seed is not None else np.random.RandomState()

        ptune = getattr(self, "ptune", None)
        pre_seq = ptune.pre_seq_len if (ptune and ptune.tuning_mode) else 0

        own_session = False
        if session is None:
            session = self._active_session
        if session is None:
            total = max_length if max_length is not None else pre_seq + prompt_len + max_new_tokens
            session = self.remote.inference_session(max_length=total, batch_size=batch)
            own_session = True
        else:
            if getattr(session, "batch_size", batch) != batch:
                raise ValueError(
                    f"this generate() call needs {batch} cache lanes "
                    f"(batch {input_ids.shape[0] // num_return_sequences} x "
                    f"num_return_sequences {num_return_sequences}) but the open "
                    f"session has batch_size={session.batch_size}; open "
                    f"model.inference_session(batch_size={batch}) or let "
                    f"generate() manage the session"
                )
            if max_length is None:
                # the cache holds the prompts, the prompt and every token but the last sampled one
                max_new_tokens = min(max_new_tokens, session.max_length - pre_seq - prompt_len + 1)

        try:
            generated = input_ids
            if prompts is None and hasattr(self, "deep_prompts_for_batch"):
                prompts = self.deep_prompts_for_batch(batch)
            if prompts is not None:
                prompts = torch.as_tensor(prompts).detach()
            # resume: only feed the tokens the session has not seen yet (its
            # position counts the shallow prompts too)
            seen_tokens = max(session.position - pre_seq, 0) if session.position else 0
            new_tokens = input_ids[:, seen_tokens:]
            if new_tokens.shape[1] == 0:
                raise ValueError(
                    f"All {prompt_len} input tokens are already in the session "
                    f"(position {session.position}); pass the sequence returned by the "
                    f"previous generate() call, which includes the pending last token"
                )
            if streamer is not None:
                streamer.put(input_ids)  # HF: the prompt goes first
            hidden = self.embed(new_tokens, with_prompts=session.position == 0)

            # the server-side fast paths: chunks of tokens generated on a
            # whole-model server, one round trip a chunk; what needs the
            # logits on the client (processors, criteria, n-gram bans,
            # min_new_tokens) keeps the per-token loop
            fastpath_ok = (
                logits_processor is None
                and stopping_criteria is None
                and not no_repeat_ngram_size
                and (min_new_tokens or 0) == 0
                and batch == 1
                and prompts is None
                and hasattr(session, "generate_remote")
            )
            rep = 1.0 if repetition_penalty is None else float(repetition_penalty)
            wants_sampling = do_sample and temperature != 0.0
            if fastpath_ok and not wants_sampling and rep == 1.0:
                result = self._server_side_greedy(
                    session, hidden, generated, max_new_tokens,
                    eos_token_id=eos_token_id, pad_token_id=pad_token_id, streamer=streamer,
                )
                if result is not None:
                    return result
                # nothing was sent: the per-token loop below starts over
            elif fastpath_ok:
                # the wire seed is the caller's, so a seeded stream repeats;
                # an unseeded call draws one
                wire_seed = int(seed) % (1 << 31) if seed is not None else int(rng.randint(1 << 31))
                result = self._server_side_sample(
                    session, hidden, generated, max_new_tokens,
                    do_sample=wants_sampling, temperature=temperature, top_k=top_k, top_p=top_p,
                    repetition_penalty=rep, wire_seed=wire_seed, eos_token_id=eos_token_id,
                    pad_token_id=pad_token_id, streamer=streamer,
                )
                if result is not None:
                    return result

            out_hidden = session.step(hidden, prompts=prompts)
            logits = self._host_logits(out_hidden)

            finished = np.zeros(batch, dtype=bool)
            for i in range(max_new_tokens):
                scores = _process_scores(
                    logits, generated,
                    repetition_penalty=repetition_penalty,
                    no_repeat_ngram_size=no_repeat_ngram_size,
                    ban_eos_token_id=eos_token_id if i < min_new_tokens else None,
                    logits_processor=logits_processor,
                )
                next_token = sample_next_token(
                    scores, do_sample=do_sample, temperature=temperature, top_k=top_k, top_p=top_p, rng=rng,
                )
                if eos_token_id is not None:
                    # HF: rows already finished emit pad (falling back to eos)
                    fill = pad_token_id if pad_token_id is not None else eos_token_id
                    next_token = np.where(finished, fill, next_token)
                    finished |= next_token == eos_token_id
                generated = np.concatenate([generated, next_token[:, None]], axis=1)
                if streamer is not None:
                    streamer.put(np.asarray(next_token))
                if eos_token_id is not None and finished.all():
                    break
                if _stop_requested(stopping_criteria, generated, scores):
                    break
                if i + 1 == max_new_tokens:
                    # the final token is deliberately NOT fed to the servers: a
                    # follow-up generate() on the same session sends it as part
                    # of its unseen-suffix prefill
                    break
                if session.position + 1 > session.max_length:
                    logger.warning("Session max_length reached; stopping generation")
                    break
                out_hidden = session.step(self.embed(next_token[:, None], with_prompts=False), prompts=prompts)
                logits = self._host_logits(out_hidden)
            if streamer is not None:
                streamer.end()
            return generated
        finally:
            if own_session:
                session.close()

    _SERVER_GEN_CHUNK = 32  # tokens a generating step asks for (the server may clamp)

    def _server_side_greedy(self, session, hidden, generated, max_new_tokens, *, eos_token_id, pad_token_id,
                            streamer):
        """Greedy generation by the server, in chunks (petals_tpu's
        ``_server_side_greedy``). Returns the final sequence, or None when
        the route cannot generate and nothing was sent (the caller's
        per-token loop takes over). A failure mid-stream finishes the tail
        here, per token: plain argmax is the whole of this path."""
        remaining = max_new_tokens
        first = True
        with_context = True
        pending_hidden = hidden  # the unfed input of the next request
        while remaining > 0:
            want = min(self._SERVER_GEN_CHUNK, remaining)
            pos_before = session.position
            # a context-only gen_sampling is exact greedy on the wire (its
            # defaults are argmax no-ops) and gives a server's draft model
            # its window
            sampling = {"context": [int(t) for t in generated[0]]} if with_context else None
            tokens = session.generate_remote(pending_hidden, want, self._embed_tokens, sampling=sampling)
            if tokens is None and first and with_context:
                # a route announcing server_gen without server_gen_sampling
                with_context = False
                tokens = session.generate_remote(pending_hidden, want, self._embed_tokens)
            if tokens is None:
                if first:
                    return None
                break  # finish the tail per token below
            first = False
            got = tokens.shape[1]  # the server may clamp the chunk
            if eos_token_id is not None:
                eos_at = np.flatnonzero(tokens[0] == eos_token_id)
                if eos_at.size:
                    j = int(eos_at[0])
                    tokens = tokens[:, : j + 1]
                    # roll the servers back so the eos token is the pending,
                    # unfed one (the resume convention)
                    session.position = pos_before + pending_hidden.shape[1] + j
                    remaining = 0
            generated = np.concatenate([generated, tokens], axis=1)
            if streamer is not None:
                streamer.put(np.asarray(tokens[0]))
            if remaining:
                remaining -= got
            if remaining <= 0:
                if streamer is not None:
                    streamer.end()
                return generated
            pending_hidden = self._embed_tokens(generated[:, -1:])  # the next chunk feeds the last token

        # a failure mid-stream: plain per-token greedy for the tail
        while remaining > 0:
            logits = self._host_logits(session.step(pending_hidden))
            next_token = logits.argmax(-1).astype(generated.dtype)
            generated = np.concatenate([generated, next_token[:, None]], axis=1)
            if streamer is not None:
                streamer.put(np.asarray(next_token))
            remaining -= 1
            if eos_token_id is not None and int(next_token[0]) == eos_token_id:
                break
            if remaining > 0:
                pending_hidden = self._embed_tokens(generated[:, -1:])
        if streamer is not None:
            streamer.end()
        return generated

    def _server_side_sample(self, session, hidden, generated, max_new_tokens, *, do_sample, temperature, top_k,
                            top_p, repetition_penalty, wire_seed, eos_token_id, pad_token_id, streamer):
        """Sampling, or greedy with a repetition penalty, by the server, in
        chunks (petals_tpu's ``_server_side_sample``): the greedy path's
        protocol plus a ``gen_sampling`` dict. Each chunk's ``offset`` is the
        count of tokens drawn so far, so a failure mid-stream finishes the
        tail per token on the same draws (``sample_next_token``'s
        ``rng_key``). Returns the final sequence, or None when the route
        cannot serve it and nothing was sent."""
        rep = float(repetition_penalty)
        base = {
            "do_sample": bool(do_sample),
            "temperature": float(temperature),
            "top_k": int(top_k or 0),
            "top_p": float(top_p) if top_p is not None else 1.0,
            "repetition_penalty": rep,
            "seed": int(wire_seed),
        }
        draws = 0  # tokens drawn so far: the next draw index
        remaining = max_new_tokens
        first = True
        pending_hidden = hidden
        while remaining > 0:
            want = min(self._SERVER_GEN_CHUNK, remaining)
            pos_before = session.position
            # the penalty's seen set (tokens drawn inside a chunk are added
            # on the server)
            sampling = dict(base, offset=draws, context=[int(t) for t in generated[0]])
            tokens = session.generate_remote(pending_hidden, want, self._embed_tokens, sampling=sampling)
            if tokens is None:
                if first:
                    return None
                break  # finish the tail per token below
            first = False
            got = tokens.shape[1]
            draws += got
            if eos_token_id is not None:
                eos_at = np.flatnonzero(tokens[0] == eos_token_id)
                if eos_at.size:
                    j = int(eos_at[0])
                    tokens = tokens[:, : j + 1]
                    session.position = pos_before + pending_hidden.shape[1] + j
                    remaining = 0
            generated = np.concatenate([generated, tokens], axis=1)
            if streamer is not None:
                streamer.put(np.asarray(tokens[0]))
            if remaining:
                remaining -= got
            if remaining <= 0:
                if streamer is not None:
                    streamer.end()
                return generated
            pending_hidden = self._embed_tokens(generated[:, -1:])

        # a failure mid-stream: per-token sampling on the stream's own draws
        while remaining > 0:
            logits = self._host_logits(session.step(pending_hidden))
            scores = apply_repetition_penalty(logits, generated, rep)
            next_token = sample_next_token(
                scores, do_sample=do_sample, temperature=temperature, top_k=top_k, top_p=top_p,
                rng_key=(wire_seed, draws),
            ).astype(generated.dtype)
            draws += 1
            generated = np.concatenate([generated, next_token[:, None]], axis=1)
            if streamer is not None:
                streamer.put(np.asarray(next_token))
            remaining -= 1
            if eos_token_id is not None and int(next_token[0]) == eos_token_id:
                break
            if remaining > 0:
                pending_hidden = self._embed_tokens(generated[:, -1:])
        if streamer is not None:
            streamer.end()
        return generated

    def _beam_search(
        self,
        input_ids: np.ndarray,  # [batch, seq]
        *,
        max_new_tokens: int,
        num_beams: int,
        session=None,
        prompts=None,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        seed: Optional[int] = None,
        eos_token_id: Optional[int] = None,
        pad_token_id: Optional[int] = None,
        length_penalty: float = 1.0,
        early_stopping: bool = False,
        repetition_penalty: float = 1.0,
        no_repeat_ngram_size: int = 0,
        min_new_tokens: int = 0,
        num_return_sequences: int = 1,
        logits_processor=None,
        stopping_criteria=None,
    ) -> np.ndarray:
        """Beam search over the swarm with HF BeamSearchScorer semantics
        (EOS finalization, length penalty, early stopping, batch > 1); each
        step reorders every server's KV cache lanes via hypo_ids (reference
        remote_generation.py beam hook + backend.py:154-158).

        ``do_sample=True`` follows HF ``_beam_sample``: candidate tokens are
        drawn (not ranked) from the warped softmax of beam-score-added
        logprobs; warpers apply temperature/top-k/top-p AFTER the beam-score
        addition, exactly like transformers. Sampled draws use this build's
        numpy RNG, as petals_tpu's do, so a seeded beam sample is the same
        stream as petals_tpu's client's.

        An explicit ``session=`` (or an enclosing ``inference_session``) is
        used when it is fresh and sized for ``batch * num_beams`` lanes —
        multi-turn beam conversations on one session are not supported (the
        reference inherits the same limitation: a session's KV lanes hold the
        LAST step's beam reordering, which a follow-up call cannot re-align)."""
        input_ids = np.asarray(input_ids)
        batch, prompt_len = input_ids.shape
        if max_new_tokens <= 0:
            # degenerate call: still honor the promised row count
            return np.repeat(input_ids, num_return_sequences, axis=0)
        if pad_token_id is None:
            pad_token_id = eos_token_id
        max_length = prompt_len + max_new_tokens
        lanes = batch * num_beams
        rng = np.random.RandomState(seed) if seed is not None else np.random.RandomState()

        ptune = getattr(self, "ptune", None)
        pre_seq = ptune.pre_seq_len if (ptune and ptune.tuning_mode) else 0
        if prompts is None and hasattr(self, "deep_prompts_for_batch"):
            prompts = self.deep_prompts_for_batch(lanes)
        if prompts is not None:
            prompts = torch.as_tensor(prompts).detach()

        own_session = False
        if session is None:
            session = self.remote.inference_session(max_length=pre_seq + max_length, batch_size=lanes)
            own_session = True
        else:
            if session.batch_size != lanes:
                raise ValueError(
                    f"beam search over batch {batch} x {num_beams} beams needs a "
                    f"session with batch_size={lanes}, got {session.batch_size}; "
                    f"open model.inference_session(batch_size={lanes}) or let "
                    f"generate() manage the session"
                )
            if session.position > 0:
                raise NotImplementedError(
                    "a session already holding beam-reordered KV lanes cannot "
                    "host a second beam call; use a fresh session per beam "
                    "generate()"
                )
            # the final chosen token is never fed, so the cache needs
            # pre_seq + prompt_len + max_new_tokens - 1 positions; clamp like
            # the sampling path instead of dying mid-beam on a short session
            budget = session.max_length - pre_seq - prompt_len + 1
            if budget <= 0:
                raise ValueError(
                    f"session max_length {session.max_length} cannot hold the "
                    f"{pre_seq + prompt_len}-token prompt (+1 generated); open a "
                    f"larger session"
                )
            if max_new_tokens > budget:
                max_new_tokens = budget
                max_length = prompt_len + max_new_tokens

        hyps = [
            _BeamHypotheses(num_beams, length_penalty, early_stopping)
            for _ in range(batch)
        ]
        done = [False] * batch
        # HF trick: all but beam 0 start at -1e9 so the first expansion draws
        # every candidate from beam 0 (identical prefixes otherwise)
        beam_scores = np.zeros((batch, num_beams), np.float64)
        beam_scores[:, 1:] = -1e9
        sequences = np.repeat(input_ids, num_beams, axis=0)  # [lanes, seq]

        try:
            out = session.step(self.embed(sequences, with_prompts=pre_seq > 0), prompts=prompts)
            hypo_ids = None
            for _step in range(max_new_tokens):
                logits = self._host_logits(out)  # [lanes, vocab]
                logprobs = _log_softmax(logits)
                logprobs = _process_scores(
                    logprobs, sequences,
                    repetition_penalty=repetition_penalty,
                    no_repeat_ngram_size=no_repeat_ngram_size,
                    ban_eos_token_id=(
                        eos_token_id if _step < min_new_tokens else None
                    ),
                    logits_processor=logits_processor,
                )
                vocab = logprobs.shape[-1]
                totals = beam_scores.reshape(lanes, 1) + logprobs  # [lanes, vocab]
                if do_sample:
                    # HF _beam_sample: warp the beam-score-added totals
                    totals = _warp_scores(
                        totals, temperature=temperature, top_k=top_k, top_p=top_p
                    )
                cur_len = sequences.shape[1]

                # HF bookkeeping: cur_len counts the token being chosen now,
                # and length penalties divide by GENERATED length only
                generated_len = cur_len + 1 - prompt_len
                next_beam_scores = np.zeros((batch, num_beams), np.float64)
                next_beam_tokens = np.zeros((batch, num_beams), np.int64)
                next_beam_idx = np.zeros((batch, num_beams), np.int64)  # lane index
                for b in range(batch):
                    if done[b]:
                        next_beam_scores[b] = 0.0
                        next_beam_tokens[b] = pad_token_id if pad_token_id is not None else 0
                        next_beam_idx[b] = b * num_beams
                        continue
                    flat = totals[b * num_beams : (b + 1) * num_beams].reshape(-1)
                    if do_sample:
                        # draw 2n candidates without replacement from the
                        # warped distribution, then rank them by score
                        # (HF: multinomial then sort by gathered scores).
                        # Cold temperatures underflow most probs to exact 0 —
                        # supplement with the best undrawn finite candidates
                        # so the beam always has 2n to rank (and the
                        # temperature->0 limit collapses to beam search)
                        probs = _softmax(flat[None, :])[0]
                        n_cand = min(2 * num_beams, int((probs > 0).sum()))
                        drawn = rng.choice(
                            flat.shape[0], size=n_cand, replace=False, p=probs
                        )
                        if n_cand < 2 * num_beams:
                            have = set(drawn.tolist())
                            extra = []
                            for i in np.argsort(-flat, kind="stable"):
                                if len(extra) == 2 * num_beams - n_cand:
                                    break
                                if not np.isfinite(flat[i]):
                                    break  # sorted: everything after is -inf too
                                if int(i) not in have:
                                    extra.append(int(i))
                            drawn = np.concatenate([drawn, np.asarray(extra, np.int64)])
                        top = drawn[np.argsort(-flat[drawn], kind="stable")]
                    else:
                        # 2*num_beams candidates guarantee num_beams non-EOS ones
                        top = np.argsort(-flat, kind="stable")[: 2 * num_beams]
                    beam_rank = 0
                    for rank, flat_idx in enumerate(top):
                        beam_of, token = int(flat_idx // vocab), int(flat_idx % vocab)
                        lane = b * num_beams + beam_of
                        if eos_token_id is not None and token == eos_token_id:
                            if rank >= num_beams:
                                continue  # HF: only top-num_beams EOS finalize
                            # the finished hypothesis INCLUDES its eos token
                            # (HF _beam_search stores running_sequences[:cur_len+1])
                            hyps[b].add(
                                np.append(sequences[lane], eos_token_id),
                                float(flat[flat_idx]),
                                generated_len=generated_len,
                            )
                        else:
                            next_beam_scores[b, beam_rank] = flat[flat_idx]
                            next_beam_tokens[b, beam_rank] = token
                            next_beam_idx[b, beam_rank] = lane
                            beam_rank += 1
                        if beam_rank == num_beams:
                            break
                    done[b] = done[b] or hyps[b].is_done(float(flat.max()), generated_len)

                beam_scores = next_beam_scores
                lane_order = next_beam_idx.reshape(-1)
                sequences = np.concatenate(
                    [sequences[lane_order], next_beam_tokens.reshape(-1, 1)], axis=1
                )
                hypo_ids = lane_order.astype(np.int64)
                if all(done):
                    break
                if _stop_requested(stopping_criteria, sequences, totals):
                    break
                if _step + 1 == max_new_tokens:
                    break
                out = session.step(self.embed(sequences[:, -1:], with_prompts=False), prompts=prompts,
                                   hypo_ids=hypo_ids)
        finally:
            if own_session:
                session.close()

        # finalize (HF BeamSearchScorer.finalize): open beams become hypotheses
        for b in range(batch):
            if done[b]:
                continue
            for beam in range(num_beams):
                lane = b * num_beams + beam
                hyps[b].add(
                    sequences[lane].copy(), float(beam_scores[b, beam]),
                    generated_len=sequences.shape[1] - prompt_len,
                )

        # HF layout: batch * num_return_sequences rows, each batch's finished
        # hypotheses in descending score order
        best = []
        for b in range(batch):
            # HF finalize sorts ascending (stable) and pops from the end, so
            # among EXACT score ties the last-added hypothesis ranks first —
            # encode that as (score, insertion_index) descending
            ranked = sorted(
                enumerate(hyps[b].beams),
                key=lambda kv: (kv[1][0], kv[0]),
                reverse=True,
            )
            best.extend(item[1] for _, item in ranked[:num_return_sequences])
        sent_lengths = [len(seq) for seq in best]
        out_len = min(max(sent_lengths), max_length)
        # HF's output_fill_value, quirk included: a FALSY pad_token_id (0) is
        # replaced by eos, so short rows' tails are filled with eos tokens
        if eos_token_id is not None:
            fill = pad_token_id or eos_token_id
        elif pad_token_id is not None:
            fill = pad_token_id
        else:
            fill = 0  # without eos every row has full length; never visible
        decoded = np.full((len(best), out_len), fill, np.int64)
        for row, seq in enumerate(best):
            decoded[row, : sent_lengths[row]] = seq[:out_len]
        return decoded



class _BeamHypotheses:
    """Finished-hypothesis pool per batch item (HF BeamHypotheses semantics:
    keep the best ``num_beams`` by length-penalized score)."""

    def __init__(self, num_beams: int, length_penalty: float, early_stopping: bool):
        self.num_beams = num_beams
        self.length_penalty = length_penalty
        self.early_stopping = early_stopping
        self.beams = []  # (penalized_score, sequence)
        self.worst_score = 1e9

    def add(self, sequence: np.ndarray, sum_logprobs: float, *, generated_len: int) -> None:
        score = sum_logprobs / (generated_len**self.length_penalty)
        if len(self.beams) < self.num_beams or score > self.worst_score:
            self.beams.append((score, sequence))
            if len(self.beams) > self.num_beams:
                worst = min(range(len(self.beams)), key=lambda i: self.beams[i][0])
                del self.beams[worst]
            self.worst_score = min(score for score, _ in self.beams)

    def is_done(self, best_sum_logprobs: float, generated_len: int) -> bool:
        if len(self.beams) < self.num_beams:
            return False
        if self.early_stopping:
            return True
        return self.worst_score >= best_sum_logprobs / (generated_len**self.length_penalty)


def _log_softmax(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float64)
    m = x.max(axis=-1, keepdims=True)
    return x - m - np.log(np.exp(x - m).sum(axis=-1, keepdims=True))
