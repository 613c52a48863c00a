"""LM serving: batched prefill + decode with request slotting.

The port of ``repro/launch/serve.py``.  The CogSys system-level insight
(adSCH interleaving, Sec. VI) maps to LM serving as continuous batching:
new requests are slotted into the fixed decode batch as old ones finish.

Two device layouts behind one API:

  * contiguous (default): the stacked caches of
    :func:`repro_torch.nn.transformer.init_cache` (KV, Mamba and xLSTM
    state), one-token prefill (the whole slot batch decoded, only the
    target slot written) — the layout of the stateful block kinds;
  * paged (``paged=PagedConfig(...)``): a shared block pool + per-slot
    block tables (:mod:`repro_torch.lm.paging`), chunked prefill (one call
    per ``prefill_chunk`` tokens), decode attention through the
    ``flash_decode`` kernel (one launch per attention layer per step on the
    card), capacity limited by the pool instead of ``max_len``, and
    ``resize()`` as a block-table edit.

The KV state is written in place; each decode step reads the sampled
tokens back to the host (one sync per step).

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch llama3.2-3b --paged
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch llama3.2-3b --smoke --paged --device cpu
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch.configs import registry
from repro_torch.device import DEFAULT_DEVICE, resolve
from repro_torch.lm import model as lm_model
from repro_torch.lm import sampling as lm_sampling
from repro_torch.lm.paging import BlockTablePool, PagedConfig, cdiv
from repro_torch.nn import moe as Moe
from repro_torch.nn import transformer as T

log = logging.getLogger(__name__)

MOE_STATS_CALLS = 1 << 20  # dropless MoE calls the device record keeps


def as_tokens(prompt) -> np.ndarray:
    """A 1-D prompt (tensor, array or list of ids) as int64 numpy."""
    if isinstance(prompt, torch.Tensor):
        prompt = prompt.detach().cpu().numpy()
    return np.asarray(prompt, np.int64).reshape(-1)


def _seed(key) -> int:
    """An int seed from an int or a ``torch.Generator``."""
    if isinstance(key, torch.Generator):
        return int(torch.randint(0, 2 ** 62, (1,), generator=key,
                                 device=key.device))
    return int(key)


class ServeEngine:
    """Static-batch continuous batching over a shared KV cache.

    ``params`` is the port's :class:`repro_torch.nn.transformer.LM`, on
    ``device`` (default ``"cuda"``).  ``last_logits`` holds the fp32
    ``[slots, vocab]`` logits of the latest decode step (rows of inactive
    slots are garbage).  A paged engine of a dropless MoE model keeps, while
    a recorder records, each MoE call's experts touched and largest group
    on the device in ``moe_stats`` (:class:`repro_torch.nn.moe.MoEStats`;
    None otherwise), and counts ``moe_calls`` and ``moe_assignments`` (the
    routed tokens times top-k)."""

    def __init__(self, cfg, params, batch_slots: int, max_len: int,
                 paged: PagedConfig | None = None, obs=None,
                 obs_track: str = "lm", device=DEFAULT_DEVICE):
        if paged is not None and not isinstance(paged, PagedConfig):
            raise TypeError(
                f"paged= expects a PagedConfig or None, got {paged!r}")
        self.device = resolve(device)
        if params.device.type != self.device.type:
            raise ValueError(f"the model lies on {params.device}, the engine "
                             f"serves on {self.device}; build or move it "
                             "there first")
        self.cfg, self.params = cfg, params
        self.max_len = max_len
        self.slots = batch_slots
        self.paged = paged
        # Spans and counters are recorded around the device calls; the NULL
        # default costs one attribute read.
        self.obs = obs if obs is not None else obs_mod.NULL
        self.obs_track = obs_track
        self.active = np.zeros(batch_slots, bool)
        self.generated: list = [[] for _ in range(batch_slots)]
        # Host mirror of each slot's KV length + capacity parking flags: a
        # decode step writes KV at position len, so a slot out of KV room
        # must NOT step again; step() parks it (active=False,
        # overflowed=True) instead.
        self.lens = np.zeros(batch_slots, np.int64)
        self.overflowed = np.zeros(batch_slots, bool)
        # Per-slot sampling override (None = the step()-level sampler args).
        self.sampling: list = [None] * batch_slots
        # Structural serving metrics: dispatches and modelled KV bytes.
        self.prefill_dispatches = 0
        self.decode_dispatches = 0
        self.kv_bytes_touched = 0
        self.last_logits = None
        self.moe_stats = None
        moe_layers = sum(cfg.kind(i).endswith("moe")
                         for i in range(cfg.n_layers))
        self._moe_per_token = (moe_layers, cfg.moe.top_k if moe_layers else 0)
        # each attention layer's window (None: full), for _kv_step_bytes
        self._attn_windows = [cfg.attn_cfg(layer=i).window
                              for i in range(cfg.n_layers)
                              if cfg.kind(i).startswith("attn")]
        if paged is not None:
            if moe_layers and cfg.moe_dropless:
                self.moe_stats = Moe.MoEStats(MOE_STATS_CALLS, self.device)
            lm_model.check_paging_supported(cfg)
            nb = paged.resolve_num_blocks(batch_slots, max_len)
            width = paged.resolve_table_width(batch_slots, max_len)
            self.blocks = BlockTablePool(nb, paged.block_size, batch_slots,
                                         width)
            self.pool = lm_model.init_pool(cfg, nb, paged.block_size,
                                           self.device)
            return
        self.cache = T.init_cache(cfg, batch_slots, max_len,
                                  device=self.device)
        # A slot's pristine state, for slot reuse: not zeros (the xLSTM
        # stabiliser m starts at -1e9), so it is sliced from a fresh cache,
        # as the reference does; one row serves every slot.
        self._fresh_cache = T.init_cache(cfg, 1, max_len, device=self.device)

    # -- contiguous layout -------------------------------------------------

    def _decode_masked(self, tok: torch.Tensor, act: torch.Tensor):
        """One decode step of the whole slot batch; only ``act`` rows write
        their KV and advance (the reference's masked merge)."""
        logits, _ = T.decode_step(self.params, self.cfg, self.cache, tok, act)
        return logits

    def _prefill(self, token: int, slot: int):
        """Prefill one token into ONE slot: decode the whole batch, write
        back only the target slot's row."""
        tok = torch.full((self.slots, 1), token, dtype=torch.int64,
                         device=self.device)
        act = torch.arange(self.slots, device=self.device) == slot
        return self._decode_masked(tok, act)

    def _reset_slot(self, slot: int) -> None:
        """A slot's cache row back to a fresh cache's, in place: O(row),
        not O(cache)."""
        for per, fresh in zip(self.cache, self._fresh_cache):
            for name, leaves in per.items():
                for k, leaf in leaves.items():
                    leaf[:, slot] = fresh[name][k][:, 0]

    # -- capacity ----------------------------------------------------------

    @property
    def slot_capacity(self) -> int:
        """Max tokens one slot can hold (cache row / block-table width)."""
        if self.paged is None:
            return self.max_len
        return self.blocks.slot_capacity

    def can_admit(self, tokens: int) -> bool:
        """Whether a fresh ``tokens``-token prompt can be admitted NOW
        (paged: enough free blocks; contiguous: fits the row)."""
        if tokens > self.slot_capacity:
            return False
        if self.paged is None:
            return True
        return self.blocks.free_blocks >= cdiv(tokens, self.paged.block_size)

    def _kv_step_bytes(self) -> int:
        """Modelled KV bytes one decode dispatch reads (all attn layers; a
        sliding layer's flash_decode reads only the blocks of its
        window)."""
        cfg = self.cfg
        G = cfg.n_kv_heads
        dh = cfg.head_dim if cfg.head_dim is not None else \
            cfg.d_model // cfg.n_heads
        int8 = cfg.kv_cache_dtype == "int8"
        per_tok = 2 * G * dh * (1 if int8 else 2) + (2 * G * 4 if int8 else 0)
        windows = self._attn_windows
        if self.paged is None:
            # dense read of the full cache
            return self.slots * self.max_len * per_tok * len(windows)
        if not self.paged.use_flash:
            # the dense gathered path reads each row's full table window
            return self.slots * self.blocks.table_width \
                * self.paged.block_size * per_tok * len(windows)
        bs = self.paged.block_size
        last = self.lens // bs  # the block of each row's new position

        def read(window):  # positions of the blocks one layer reads
            if window is None:
                return int((last + 1).sum()) * bs
            first = np.maximum(self.lens + 1 - window, 0) // bs
            return int((last - first + 1).sum()) * bs

        return per_tok * sum(read(w) for w in windows)

    def _count_moe(self, tokens: int) -> None:
        """Host counters of one paged call's MoE layers: ``moe_calls`` and
        ``moe_assignments`` (``tokens`` routed times top-k, a layer)."""
        layers, k = self._moe_per_token
        if layers and self.obs.enabled:
            self.obs.count("moe_calls", layers, engine=self.obs_track)
            self.obs.count("moe_assignments", layers * k * tokens,
                           engine=self.obs_track)

    # -- admission ---------------------------------------------------------

    def release_slot(self, slot: int) -> None:
        """Stop serving a slot and (paged) return its blocks to the pool."""
        self.active[slot] = False
        self.sampling[slot] = None
        if self.paged is not None:
            self.blocks.release(slot)

    @torch.no_grad()
    def add_request(self, slot: int, prompt, sampling=None):
        """Prefill a prompt into one slot.

        The slot's prior state is released first (slots are reused across
        requests).  Only ``prompt[:-1]`` is prefilled; the last prompt token
        is seeded into ``generated`` so the next ``step()`` feeds it —
        writing its KV exactly once and producing the true first next-token
        logits.  ``sampling`` (a :class:`repro_torch.lm.sampling.SamplingSpec`)
        overrides the engine-level sampler for this slot.  Returns the
        target slot's ``[1, vocab]`` logits after the last *prefilled* token
        (``None`` for prompts shorter than 2 tokens).
        """
        toks = as_tokens(prompt)
        n = int(toks.shape[0])
        if n == 0:  # nothing to serve; leave the slot parked
            return None
        if n > self.slot_capacity:
            # prompt[:-1] prefills and the seeded last token still needs a KV
            # position on the first step(): len(prompt) rows of cache total
            raise ValueError(
                f"prompt of {n} tokens exceeds the cache capacity "
                f"{self.slot_capacity}"
                + ("" if self.paged is not None else
                   f" (max_len={self.max_len})"))
        if sampling is not None and \
                not isinstance(sampling, lm_sampling.SamplingSpec):
            raise TypeError(f"sampling= expects a SamplingSpec or None, "
                            f"got {sampling!r}")
        logits = None
        disp0 = self.prefill_dispatches
        if self.paged is not None:
            self.blocks.release(slot)
            if not self.blocks.ensure(slot, n):
                self.blocks.release(slot)
                raise RuntimeError(
                    f"KV pool exhausted admitting a {n}-token prompt "
                    f"(free blocks: {self.blocks.free_blocks} x "
                    f"{self.paged.block_size}); gate admissions on "
                    "can_admit()")
            row_table = torch.from_numpy(self.blocks.table()[slot]).to(
                self.device)
            C = self.paged.prefill_chunk
            body = toks[:-1]
            for c0 in range(0, len(body), C):
                count = len(body[c0:c0 + C])
                padded = np.zeros((1, C), np.int64)
                padded[0, :count] = body[c0:c0 + C]
                with self.obs.span("prefill-chunk", track=self.obs_track,
                                   cat="lm", args={"slot": slot, "pos": c0,
                                                   "tokens": count}):
                    lg, _ = lm_model.prefill_chunk_paged(
                        self.params, self.cfg, self.pool, row_table, c0,
                        torch.from_numpy(padded).to(self.device), count,
                        obs=self.obs, obs_track=self.obs_track,
                        moe_stats=self.moe_stats)
                self.prefill_dispatches += 1
                self._count_moe(count)
                logits = lg[:, count - 1]
        else:
            with self.obs.span("prefill", track=self.obs_track, cat="lm",
                               args={"slot": slot, "tokens": n - 1}):
                self._reset_slot(slot)
                for t in range(n - 1):
                    lg = self._prefill(int(toks[t]), slot)
                    self.prefill_dispatches += 1
                    logits = lg[slot]
        if self.obs.enabled and self.prefill_dispatches > disp0:
            self.obs.count("prefill_dispatches",
                           self.prefill_dispatches - disp0,
                           engine=self.obs_track)
        self.active[slot] = True
        self.generated[slot] = [int(toks[-1])]
        self.lens[slot] = n - 1
        self.overflowed[slot] = False
        self.sampling[slot] = sampling
        return logits

    # -- decode ------------------------------------------------------------

    def _park_full(self) -> None:
        """Park active slots that have no KV room for this step's write."""
        if self.paged is None:
            full = self.active & (self.lens >= self.max_len)
            if full.any():
                self.active[full] = False
                self.overflowed[full] = True
            return
        # Pool-exhaustion parking: grow each slot's block list for one more
        # position, in ascending slot order (deterministic under replay); a
        # slot the pool cannot serve parks but KEEPS its blocks — the caller
        # retires it and release_slot() returns them.
        for s in range(self.slots):
            if self.active[s] and \
                    not self.blocks.ensure(s, int(self.lens[s]) + 1):
                self.active[s] = False
                self.overflowed[s] = True

    @torch.no_grad()
    def step(self, sampler="greedy", temperature=1.0, key=None):
        """One decode step for the active slots; returns the sampled tokens
        ([slots] int64 tensor on the CPU; entries of inactive slots are
        meaningless).

        Slots out of KV room are parked first (``active`` cleared,
        ``overflowed`` set).  Returns ``None`` when parking leaves nothing
        active.  ``sampler="categorical"`` requires an explicit ``key`` (an
        int seed or a ``torch.Generator``) and a positive ``temperature``;
        per-slot :class:`SamplingSpec`s from ``add_request`` override these
        engine-level args.
        """
        if sampler != "greedy":
            if key is None:
                raise ValueError(
                    f"sampler={sampler!r} needs an explicit PRNG key "
                    "(key=<int seed> or a torch.Generator); only the greedy "
                    "sampler is key-free")
            if not temperature > 0:
                raise ValueError(
                    f"temperature must be > 0, got {temperature} — "
                    "temperature=0 is greedy argmax; use sampler='greedy'")
        self._park_full()
        if not self.active.any():
            return None
        dev = self.device
        last = torch.tensor([self.generated[s][-1] if self.generated[s] else 0
                             for s in range(self.slots)],
                            dtype=torch.int64)[:, None].to(dev)
        act = torch.from_numpy(self.active.copy()).to(dev)
        if self.paged is not None:
            routed = int(self.active.sum())
            logits, _ = lm_model.decode_step_paged(
                self.params, self.cfg, self.pool,
                torch.from_numpy(self.blocks.table()).to(dev),
                torch.from_numpy(self.lens.astype(np.int32)).to(dev), last,
                act, use_flash=self.paged.use_flash, obs=self.obs,
                obs_track=self.obs_track, moe_stats=self.moe_stats,
                routed=routed)
            self._count_moe(routed)
        else:
            logits = self._decode_masked(last, act)
        self.last_logits = logits[:, -1]
        self.decode_dispatches += 1
        kv_bytes = self._kv_step_bytes()
        self.kv_bytes_touched += kv_bytes
        if self.obs.enabled:
            self.obs.count("decode_dispatches", 1, engine=self.obs_track)
            self.obs.count("kv_bytes_touched", kv_bytes,
                           engine=self.obs_track)
        self.lens[self.active] += 1
        if sampler == "greedy":
            nxt = torch.argmax(self.last_logits, dim=-1).cpu().numpy()
        else:
            nxt = lm_sampling.categorical(self.last_logits, _seed(key),
                                          temperature).cpu().numpy()
        for s in range(self.slots):
            if not self.active[s]:
                continue
            if self.sampling[s] is not None:
                nxt[s] = lm_sampling.sample_token(
                    self.last_logits[s], self.sampling[s], int(self.lens[s]))
            self.generated[s].append(int(nxt[s]))
        return torch.from_numpy(nxt)

    # -- warm handoff ------------------------------------------------------

    def resize(self, slots: int, carry=()) -> None:
        """Re-slot to ``slots`` rows, carrying ``carry`` old slots into new
        rows 0.. in order — a pure block-table edit: carried slots' KV
        blocks are untouched in the pool, so their decode trajectories are
        bit-equal across the resize.  Paged engines only; the contiguous
        cache would need a buffer reshape (``LMEngine.resize`` replays
        instead)."""
        if self.paged is None:
            raise ValueError(
                "resize() needs the paged KV path (paged=PagedConfig()); "
                "the contiguous cache cannot re-slot without a reshape")
        carry = list(carry)
        if any(c < 0 or c >= self.slots for c in carry):
            raise ValueError(f"carry={carry} outside 0..{self.slots - 1}")
        self.blocks.resize(slots, carry)
        self.active = np.array(
            [self.active[c] for c in carry] + [False] * (slots - len(carry)),
            bool)
        self.lens = np.array(
            [self.lens[c] for c in carry] + [0] * (slots - len(carry)),
            np.int64)
        self.overflowed = np.array(
            [self.overflowed[c] for c in carry]
            + [False] * (slots - len(carry)), bool)
        self.generated = [self.generated[c] for c in carry] + \
            [[] for _ in range(slots - len(carry))]
        self.sampling = [self.sampling[c] for c in carry] + \
            [None] * (slots - len(carry))
        self.slots = slots


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write a Chrome-trace JSON of the run to PATH")
    args = ap.parse_args(argv)
    if not logging.getLogger().handlers and not log.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(message)s"))
        log.addHandler(handler)
        log.setLevel(logging.INFO)
    spec = registry.get(args.arch)
    cfg = spec.smoke() if args.smoke else spec.full()
    dev = resolve(args.device)
    params = T.init(cfg, 0, dev)
    log.info("%s: %s params on %s; serving batch=%d", cfg.name,
             format(T.param_count(params), ","), dev, args.batch)
    rec = obs_mod.Recorder() if args.trace else None
    eng = ServeEngine(cfg, params, args.batch, args.prompt_len + args.gen + 1,
                      paged=PagedConfig() if args.paged else None, obs=rec,
                      device=dev)
    prompt = torch.randint(0, cfg.vocab, (args.prompt_len,),
                           generator=torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    for s in range(args.batch):
        eng.add_request(s, prompt)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prefill_t = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(args.gen):
        eng.step()  # reads the tokens back: synchronous
    dec_t = time.perf_counter() - t0
    tps = args.batch * args.gen / dec_t
    log.info("prefill %.1fms (%d dispatches); decode %d steps x %d slots "
             "in %.1fms -> %.1f tok/s", prefill_t * 1e3,
             eng.prefill_dispatches, args.gen, args.batch, dec_t * 1e3, tps)
    log.info("sample: %s", eng.generated[0][:16])
    if rec is not None:
        rec.write_chrome_trace(args.trace)
        log.info("trace written to %s (open in ui.perfetto.dev)", args.trace)


if __name__ == "__main__":
    main()
