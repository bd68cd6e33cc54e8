"""Batched serving engine: slot-based continuous batching over a static
KV cache, greedy or temperature sampling on the host, family-agnostic
(``src/repro/serve/engine.py``).

``prefill`` fills a slot's cache from a prompt; ``step`` emits one token
for every live slot.  Requests are admitted into free slots as they arrive.
The engine is also the system's in situ consumer of checkpoints:
``swap_params`` hot-swaps weights between steps.

The engine runs on ``cuda:0`` unless the caller passes a device, and raises
when CUDA is unavailable; the CPU tests pass ``device=torch.device("cpu")``.
Everything runs under ``torch.no_grad()`` with the model's parameters frozen.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, List, Mapping, Optional

import numpy as np
import torch

from ..convert import torch_dtype
from ..models.registry import get_family

__all__ = ["Request", "ServeConfig", "Engine", "default_device"]


def default_device(device: Any = None) -> torch.device:
    """``device`` if given, else ``cuda:0``; raises when CUDA is
    unavailable rather than running on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port runs on cuda:0; "
                           "pass device=torch.device('cpu') to run on the CPU")
    return torch.device("cuda", 0)


@dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0     # 0 = greedy
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


@dataclass(frozen=True)
class ServeConfig:
    max_slots: int = 8
    max_len: int = 512
    cache_dtype: str = "bfloat16"


class Engine:
    def __init__(self, cfg, serve_cfg: ServeConfig, params=None, device=None,
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.scfg = serve_cfg
        self.fam = get_family(cfg)
        self.device = default_device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            params = self.fam.init(cfg, generator, self.device)
        self.params = params.requires_grad_(False)
        self._caches: List[Any] = [None] * serve_cfg.max_slots
        self._slot_req: List[Optional[Request]] = [None] * serve_cfg.max_slots
        self._queue: List[Request] = []
        self._rng = np.random.default_rng(0)

    # ------------------------------------------------------------- weights
    def swap_params(self, params) -> None:
        """Hot-swap weights (in situ checkpoint consumption): a model of the
        same family, or a state dict loaded into the current one."""
        if isinstance(params, Mapping):
            with torch.no_grad():
                self.params.load_state_dict(params)
        else:
            self.params = params.requires_grad_(False)

    # ------------------------------------------------------------- requests
    def submit(self, req: Request) -> None:
        req.t_submit = time.monotonic()
        self._queue.append(req)

    @torch.no_grad()
    def _admit(self) -> None:
        for slot in range(self.scfg.max_slots):
            if self._slot_req[slot] is None and self._queue:
                req = self._queue.pop(0)
                self._slot_req[slot] = req
                cache = self.fam.init_cache(
                    self.cfg, 1, self.scfg.max_len,
                    dtype=torch_dtype(self.scfg.cache_dtype), device=self.device)
                tokens = torch.as_tensor(np.asarray(req.prompt, np.int64)[None, :],
                                         device=self.device)
                logits, cache = self.fam.prefill(self.params, self.cfg,
                                                 self._batch(tokens), cache)
                tok = self._sample(logits[:, -1], req.temperature)
                req.out_tokens.append(int(tok[0]))
                req.t_first = time.monotonic()
                self._caches[slot] = (cache, tok)

    def _batch(self, tokens: torch.Tensor) -> dict:
        """The prompt and, as the reference engine gives them, zero stub
        inputs of the frontends the port does not model: ``vision_embeds``
        (1, vision_tokens, d) for vlm, ``frames`` (1, source_len, d) for
        encdec, in the config's dtype."""
        batch = {"tokens": tokens}
        cfg, dt = self.cfg, torch_dtype(self.cfg.dtype)
        if cfg.family == "vlm":
            batch["vision_embeds"] = torch.zeros(
                (1, cfg.vision_tokens, cfg.d_model), dtype=dt, device=self.device)
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros(
                (1, cfg.source_len, cfg.d_model), dtype=dt, device=self.device)
        return batch

    def _sample(self, logits: torch.Tensor, temperature: float) -> np.ndarray:
        logits = logits.float().cpu().numpy()
        if temperature <= 0:
            return np.argmax(logits, axis=-1).astype(np.int32)
        z = logits / temperature
        z = z - z.max(axis=-1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(axis=-1, keepdims=True)
        return np.array(
            [self._rng.choice(p.shape[-1], p=row) for row in p], np.int32)

    # ---------------------------------------------------------------- step
    @torch.no_grad()
    def step(self) -> int:
        """Admit waiting requests, run one decode step for live slots.
        Returns the number of live slots plus waiting requests."""
        self._admit()
        live = 0
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            cache, tok = self._caches[slot]
            token = torch.as_tensor(tok.reshape(1, 1).astype(np.int64),
                                    device=self.device)
            logits, cache = self.fam.decode_step(self.params, self.cfg, token,
                                                 cache)
            nxt = self._sample(logits[:, -1], req.temperature)
            req.out_tokens.append(int(nxt[0]))
            self._caches[slot] = (cache, nxt)
            if len(req.out_tokens) >= req.max_new_tokens:
                req.done = True
                req.t_done = time.monotonic()
                self._slot_req[slot] = None
                self._caches[slot] = None
            else:
                live += 1
        return live + len(self._queue)

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if self.step() == 0 and not self._queue:
                return
        raise RuntimeError("serve loop did not drain")
