"""Continuous-batching LLM decode engine in PyTorch, the port's vLLM counterpart (a port
of ``funasr_tpu/llm/engine.py``; FunASR ``funasr/models/fun_asr_nano/inference_vllm.py``).

A fixed pool of slots shares one (slots, cache_len) K / V cache per layer; each decode
step advances every active slot by one token, so requests join between steps. Kept from
the JAX engine:

* **chunked prefill**: a prompt prefills ``prefill_chunk`` rows a step, batched over the
  prefilling slots, interleaved with the batch decode (``_prefill_one_chunk``);
* **a cache that doubles on demand** from ``init_cache_len`` up to ``max_len``
  (``_ensure_capacity``; the old rows are copied into the new buffer);
* **the LRU prefix cache**: a request's ``prefix_len`` leading rows (the ChatML prefix
  every ASR request repeats) are snapshotted on first sight and copied into the slot on
  a hit, which skips their prefill (K / V rows are per-position projections, so reuse is
  exact);
* **device-resident prompt batches** (``submit_prompt_batch``): a (B, T, D) tensor on
  the device, sliced per chunk on the device, never copied to the host;
* **multi-step greedy decode** (``_decode_multi``): ``decode_chunk`` (32) steps with the
  argmax, EOS and budget tracking on the device, then one fetch of (B, 32) ids. The loop
  queues its steps with no host sync inside it: no ``.item()``, no Python branch on a
  device value.

Sampling (``temperature > 0``) runs on the host's copy of the logits row with a
``torch.Generator`` per request, seeded from the engine's ``seed`` and the request id,
so a run is reproducible (the JAX engine draws from a numpy generator seeded alike; the
two do not draw the same tokens). The K / V cache is bf16 unless ``dtype`` says
otherwise. The engine runs where its model's weights are.

Counters for the chip check: ``n_steps`` engine steps, ``n_syncs`` device-to-host fetches.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from funasr_tpu_torch.utils.bucket import bucket_length

_EOS_PAD = 8  # fixed eos-id column width of the multi-step decode


@dataclasses.dataclass
class Request:
    request_id: int
    input_embeds: Optional[np.ndarray] = None  # (T, D) prompt embeddings on the host
    max_new_tokens: int = 256
    eos_token_ids: tuple = ()
    temperature: float = 0.0          # 0 = greedy
    prefix_len: int = 0               # leading rows shared across requests
    # a device-resident prompt (submit_prompt_batch): row dev_row of a shared
    # (B, T, D) device buffer, prompt_len valid rows
    dev_buffer: Optional[torch.Tensor] = None
    dev_row: int = 0
    prompt_len: int = 0
    # filled by the engine:
    output_ids: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    stream_cb: Optional[Callable[[int], None]] = None
    _rng: Optional[torch.Generator] = None
    _prefix_key: Optional[tuple] = None

    def __post_init__(self):
        if self.input_embeds is not None:
            self.prompt_len = int(self.input_embeds.shape[0])


class LLMEngine:
    def __init__(self, lm, num_slots: int = 8, max_len: int = 2048,
                 dtype=torch.bfloat16, prefill_chunk: int = 128,
                 init_cache_len: int = 256, seed: int = 0):
        self.lm = lm
        self.device = lm.device
        self.num_slots = num_slots
        self.max_len = max_len
        self.dtype = dtype
        self.prefill_chunk = max(32, int(prefill_chunk))
        self.seed = seed
        self.cache_len = 1
        while self.cache_len < min(init_cache_len, max_len):
            self.cache_len *= 2
        self.cache_len = min(self.cache_len, max_len)
        self.kv = lm.init_kv_cache(num_slots, self.cache_len, dtype, self.device)
        self.slot_req: List[Optional[Request]] = [None] * num_slots
        self.slot_len = np.zeros((num_slots,), np.int32)      # valid cache rows
        self.slot_new = np.zeros((num_slots,), np.int32)      # generated so far
        self.slot_prefill_pos = np.zeros((num_slots,), np.int32)
        self.last_token_embed = torch.zeros((num_slots, 1, lm.cfg.hidden_size), dtype=dtype,
                                            device=self.device)
        self.queue: List[Request] = []
        self.n_cache_grows = 0
        # prefix cache: key -> (plen, [(k_rows, v_rows) per layer]), LRU
        self.prefix_cache: collections.OrderedDict = collections.OrderedDict()
        self.prefix_cache_max = 16
        self.min_prefix_len = 8
        self.n_prefix_hits = 0
        # device steps per host sync at steady state (see _decode_multi)
        self.decode_chunk = 32
        self.n_steps = 0
        self.n_syncs = 0

    def _ids(self, values):
        return torch.as_tensor(np.asarray(values), dtype=torch.long, device=self.device)

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        self.n_syncs += 1
        return t.cpu().numpy()

    # -- device programs -------------------------------------------------------

    def _prefill(self, embeds, slots, starts, valids):
        """Prompt slices for S slots: embeds (S, t, D) covers global positions
        starts[i] .. starts[i] + t of each slot's sequence (valids[i] <= t real rows).
        Rows may repeat one slot (shape padding); duplicates write identical rows.
        Returns (last-position logits (S, V), greedy first tokens (S,), their embeds
        (S, 1, D)); only the last valid position of each slice goes through the head."""
        t = embeds.shape[1]
        positions = starts[:, None] + torch.arange(t, device=self.device)[None]
        sub_kv = [{"k": c["k"][slots], "v": c["v"][slots]} for c in self.kv]
        x, sub_kv = self.lm.forward_hidden(embeds, positions, sub_kv, starts, starts + valids)
        for c, s in zip(self.kv, sub_kv):
            c["k"][slots] = s["k"]
            c["v"][slots] = s["v"]
        idx = (valids - 1)[:, None, None].expand(-1, 1, x.shape[-1])
        last = self.lm.logits_head(torch.gather(x, 1, idx))[:, 0]
        first_tok = last.argmax(dim=-1)
        return last, first_tok, self.lm.embed(first_tok[:, None], self.dtype)

    def _decode(self, token_embeds, slot_lens):
        """One step for all slots: token_embeds (B, 1, D), slot_lens (B,) -> next logits
        (B, V). Inactive and prefilling slots give garbage rows that the next prefill
        overwrites (it covers position slot_len)."""
        logits, _ = self.lm.forward(token_embeds, slot_lens[:, None], self.kv, slot_lens,
                                    slot_lens + 1)
        return logits[:, 0]

    def _decode_multi(self, token_embeds, lens, act, eos_ids, rem, k: int):
        """``k`` greedy steps on the device with EOS and budget tracking, queued with no
        host sync: token_embeds (B, 1, D) each slot's last token, act (B,) bool,
        eos_ids (B, E) padded with -2, rem (B,) budgets. Returns (tokens (B, k), -1
        where not generated, last embeds). Finished and inactive slots stop advancing,
        so their writes stay at a position the next prefill overwrites."""
        toks = []
        embeds = token_embeds
        for _ in range(k):
            logits, _ = self.lm.forward(embeds, lens[:, None], self.kv, lens, lens + 1)
            tok = torch.where(act, logits[:, 0].argmax(dim=-1), -1)
            hit_eos = (tok[:, None] == eos_ids).any(dim=1)
            rem = rem - act.long()
            new_act = act & ~hit_eos & (rem > 0)
            lens = lens + act.long()
            next_emb = self.lm.embed(tok.clamp_min(0)[:, None], self.dtype)
            embeds = torch.where(act[:, None, None], next_emb, embeds)
            act = new_act
            toks.append(tok)
        return torch.stack(toks, dim=1), embeds

    # -- cache growth -----------------------------------------------------------

    def _ensure_capacity(self, needed: int):
        needed = min(needed, self.max_len)
        if needed <= self.cache_len:
            return
        new_len = self.cache_len
        while new_len < needed:
            new_len *= 2
        new_len = min(new_len, self.max_len)
        old = self.cache_len
        for c in self.kv:
            for name, v in c.items():
                grown = torch.zeros(v.shape[:1] + (new_len,) + v.shape[2:], dtype=v.dtype,
                                    device=v.device)
                grown[:, :old] = v
                c[name] = grown
        self.cache_len = new_len
        self.n_cache_grows += 1

    # -- host loop --------------------------------------------------------------

    def submit(self, req: Request):
        self.queue.append(req)

    def submit_prompt_batch(self, embeds, lens, max_new_tokens: int = 256,
                            eos_token_ids: tuple = (),
                            request_ids: Optional[List[int]] = None,
                            stream_cbs: Optional[List] = None) -> List[Request]:
        """Submit prompts that live on the device: ``embeds`` (B, T, D) (the audio
        encoder's output spliced into the prompt), ``lens`` each row's valid length.
        Each chunk is sliced from the shared buffer on the device. Greedy only."""
        lens = np.asarray(lens)
        b, t = int(embeds.shape[0]), int(embeds.shape[1])
        pad = -t % self.prefill_chunk
        if pad:  # chunk slices [start, start + tb) stay in bounds
            embeds = F.pad(embeds, (0, 0, 0, pad))
        reqs = []
        for i in range(b):
            req = Request(request_id=(request_ids[i] if request_ids else i),
                          dev_buffer=embeds, dev_row=i,
                          prompt_len=int(min(lens[i], self.max_len - 1)),
                          max_new_tokens=max_new_tokens, eos_token_ids=eos_token_ids,
                          stream_cb=stream_cbs[i] if stream_cbs else None)
            reqs.append(req)
            self.submit(req)
        return reqs

    def _prefix_key(self, req: Request) -> Optional[tuple]:
        if req.input_embeds is None:
            return None  # a device-resident prompt: its bytes never reach the host
        plen = int(req.prefix_len)
        if plen < self.min_prefix_len or plen >= req.input_embeds.shape[0]:
            return None
        if req._prefix_key is None:
            digest = hashlib.blake2b(
                np.ascontiguousarray(req.input_embeds[:plen]).tobytes(),
                digest_size=16).hexdigest()
            req._prefix_key = (plen, digest)
        return req._prefix_key

    def _admit(self):
        """Assign queued requests to free slots (bookkeeping: the prompt prefills chunk
        by chunk in later steps). A prefix-cache hit copies the slot's K / V rows and
        skips the shared span."""
        for slot in range(self.num_slots):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.pop(0)
                if req.prompt_len >= self.max_len:
                    req.prompt_len = self.max_len - 1
                    if req.input_embeds is not None:
                        req.input_embeds = req.input_embeds[: self.max_len - 1]
                self.slot_req[slot] = req
                self.slot_len[slot] = 0
                self.slot_new[slot] = 0
                self.slot_prefill_pos[slot] = 0
                key = self._prefix_key(req)
                if key is not None and key in self.prefix_cache:
                    plen, rows = self.prefix_cache[key]
                    self.prefix_cache.move_to_end(key)
                    self._ensure_capacity(plen + 1)
                    for c, (k_rows, v_rows) in zip(self.kv, rows):
                        c["k"][slot, :plen] = k_rows
                        c["v"][slot, :plen] = v_rows
                    self.slot_prefill_pos[slot] = plen
                    self.slot_len[slot] = plen
                    self.n_prefix_hits += 1

    def _maybe_store_prefix(self, slot: int, prev_pos: int):
        """On the chunk that crossed ``prefix_len``, snapshot rows 0 .. plen of the
        slot's K / V."""
        req = self.slot_req[slot]
        key = self._prefix_key(req)
        if key is None or key in self.prefix_cache:
            return
        plen = key[0]
        if not (prev_pos < plen <= int(self.slot_prefill_pos[slot])):
            return
        rows = [(c["k"][slot, :plen].clone(), c["v"][slot, :plen].clone()) for c in self.kv]
        self.prefix_cache[key] = (plen, rows)
        if len(self.prefix_cache) > self.prefix_cache_max:
            self.prefix_cache.popitem(last=False)

    def _prefilling_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req)
                if r is not None and self.slot_prefill_pos[i] < r.prompt_len]

    def _prefill_one_chunk(self):
        """Advance every prefilling slot by one chunk, one batched forward per chunk
        length bucket (device-resident prompts also group by buffer and chunk start)."""
        slots = self._prefilling_slots()
        if not slots:
            return
        groups = {}
        for slot in slots:
            req = self.slot_req[slot]
            start = int(self.slot_prefill_pos[slot])
            valid = min(self.prefill_chunk, req.prompt_len - start)
            tb = bucket_length(valid, minimum=32, multiple=32)
            # a padded slice must not spill past max_len: the cache write wraps modulo
            # its length and would overwrite the prompt's own first rows
            tb = min(tb, self.max_len - start)
            if req.dev_buffer is not None:
                key = (tb, id(req.dev_buffer), start)
            else:
                key = (tb, None, None)
            groups.setdefault(key, []).append((slot, start, valid))
        for (tb, buf_id, _), entries in groups.items():
            self._ensure_capacity(max(start + tb for _, start, _ in entries) + 1)
            # the slot axis padded to a power of two by repeating entry 0, as in JAX
            s = 1
            while s < len(entries):
                s *= 2
            padded = entries + [entries[0]] * (s - len(entries))
            slots_t = self._ids([e[0] for e in padded])
            starts_t = self._ids([e[1] for e in padded])
            valids_t = self._ids([e[2] for e in padded])
            if buf_id is not None:
                buffer = self.slot_req[padded[0][0]].dev_buffer
                start = padded[0][1]
                # tb may pass a short buffer's padded T on the final chunk: the slice is
                # clamped to the buffer, the extra rows are masked by valids
                t_eff = min(tb, buffer.shape[1] - start)
                rows = self._ids([self.slot_req[e[0]].dev_row for e in padded])
                embeds = buffer[:, start:start + t_eff][rows].to(self.dtype)
            else:
                dim = self.slot_req[padded[0][0]].input_embeds.shape[1]
                host = np.zeros((s, tb, dim), np.float32)
                for i, (slot, start, valid) in enumerate(padded):
                    host[i, :valid] = self.slot_req[slot].input_embeds[start: start + valid]
                embeds = torch.from_numpy(host).to(self.device, self.dtype)
            last_logits, first_toks, first_embs = self._prefill(embeds, slots_t, starts_t,
                                                                valids_t)
            finals = []
            for i, (slot, start, valid) in enumerate(entries):
                req = self.slot_req[slot]
                self.slot_prefill_pos[slot] = start + valid
                self.slot_len[slot] = start + valid
                self._maybe_store_prefix(slot, start)
                if start + valid >= req.prompt_len:
                    finals.append((i, slot))
            if not finals:
                continue
            greedy = all((self.slot_req[slot].temperature or 0.0) == 0.0
                         for _, slot in finals)
            toks_np = self._fetch(first_toks) if greedy else None
            rows_np = None if greedy else self._fetch(last_logits)
            set_slots = []
            for i, slot in finals:  # the final slice emits the first token
                req = self.slot_req[slot]
                tok = int(toks_np[i]) if greedy else self._sample(rows_np[i], req)
                req.output_ids.append(tok)
                if req.stream_cb:
                    req.stream_cb(tok)
                self.slot_new[slot] = 1
                if greedy:
                    set_slots.append(i)
                else:
                    self.last_token_embed[slot] = self.lm.embed(self._ids([tok]), self.dtype)
                if tok in req.eos_token_ids or req.max_new_tokens <= 1:
                    self._finish(slot)
            if set_slots:
                idx = self._ids([entries[i][0] for i in set_slots])
                self.last_token_embed[idx] = first_embs[self._ids(set_slots)]

    def _sample(self, logits: np.ndarray, req: Request) -> int:
        if req.temperature and req.temperature > 0:
            if req._rng is None:
                seed = np.random.SeedSequence([self.seed, req.request_id]).generate_state(1)[0]
                req._rng = torch.Generator().manual_seed(int(seed))
            x = (torch.from_numpy(np.asarray(logits, np.float64))
                 - float(np.max(logits))) / req.temperature
            probs = torch.softmax(x, dim=-1)
            return int(torch.multinomial(probs, 1, generator=req._rng))
        return int(np.argmax(logits))

    def _finish(self, slot: int):
        req = self.slot_req[slot]
        req.done = True
        self.slot_req[slot] = None
        self.slot_len[slot] = 0
        self.slot_new[slot] = 0
        self.slot_prefill_pos[slot] = 0

    @torch.no_grad()
    def step(self) -> bool:
        """Admit + one prefill slice + one decode step (or ``decode_chunk`` greedy steps)
        for all active slots. Returns True while anything is in flight."""
        self.n_steps += 1
        self._admit()
        self._prefill_one_chunk()
        prefilling = set(self._prefilling_slots())
        active_slots = [i for i, r in enumerate(self.slot_req)
                        if r is not None and i not in prefilling and self.slot_new[i] > 0]
        if not active_slots:
            return bool(self.queue) or bool(prefilling) or any(
                r is not None for r in self.slot_req)
        # greedy batches take the argmax on the device: one step while something wants
        # to interleave (a queued admission, a prefill in flight, per-token callbacks),
        # decode_chunk steps per host sync at steady state; temperature > 0 keeps the
        # host logits path
        if all((self.slot_req[s].temperature or 0.0) == 0.0
               and len(self.slot_req[s].eos_token_ids) <= _EOS_PAD for s in active_slots):
            interleave = (bool(self.queue) or bool(prefilling)
                          or any(self.slot_req[s].stream_cb is not None for s in active_slots))
            return self._step_multi(active_slots, 1 if interleave else self.decode_chunk)
        self._ensure_capacity(int(self.slot_len[active_slots].max()) + 2)
        logits_np = self._fetch(self._decode(self.last_token_embed, self._ids(self.slot_len)))
        new_tokens = np.zeros((self.num_slots,), np.int64)
        for slot in active_slots:
            req = self.slot_req[slot]
            tok = self._sample(logits_np[slot], req)
            req.output_ids.append(tok)
            if req.stream_cb:
                req.stream_cb(tok)
            self.slot_len[slot] += 1
            self.slot_new[slot] += 1
            new_tokens[slot] = tok
            if tok in req.eos_token_ids or self.slot_new[slot] >= req.max_new_tokens \
                    or self.slot_len[slot] >= self.max_len - 1:
                self._finish(slot)
        self.last_token_embed = self.lm.embed(self._ids(new_tokens)[:, None], self.dtype)
        return True

    def _step_multi(self, active_slots, k: int) -> bool:
        """k device steps and one host fetch (see _decode_multi)."""
        self._ensure_capacity(int(self.slot_len[active_slots].max()) + k + 1)
        b = self.num_slots
        active = np.zeros((b,), bool)
        remaining = np.zeros((b,), np.int64)
        eos_ids = np.full((b, _EOS_PAD), -2, np.int64)
        for s in active_slots:
            req = self.slot_req[s]
            active[s] = True
            remaining[s] = max(1, min(req.max_new_tokens - self.slot_new[s],
                                      self.max_len - 1 - self.slot_len[s]))
            for j, e in enumerate(req.eos_token_ids):
                eos_ids[s, j] = e
        toks, embeds = self._decode_multi(
            self.last_token_embed, self._ids(self.slot_len),
            torch.from_numpy(active).to(self.device), self._ids(eos_ids),
            self._ids(remaining), k)
        toks = self._fetch(toks)  # (B, k): the only fetch of the k steps
        self.last_token_embed = embeds
        for s in active_slots:
            req = self.slot_req[s]
            for t in toks[s]:
                tok = int(t)
                if tok < 0:
                    break
                req.output_ids.append(tok)
                if req.stream_cb:
                    req.stream_cb(tok)
                self.slot_len[s] += 1
                self.slot_new[s] += 1
                if (tok in req.eos_token_ids or self.slot_new[s] >= req.max_new_tokens
                        or self.slot_len[s] >= self.max_len - 1):
                    self._finish(s)
                    break
        return True

    def generate(self, requests: List[Request]) -> List[Request]:
        """Blocking batch generate (continuous batching underneath)."""
        for r in requests:
            self.submit(r)
        while any(not r.done for r in requests):
            if not self.step() and any(not r.done for r in requests):
                break
        return requests
