"""Plan cache: derive once, persist to ``runs/tuneplans_torch.json``, reuse.

The port of ``repro.tune.cache``.  The key is
``kernel|shape_sig|dtype|spec_fingerprint``; a calibration (or any change
to the spec's constants) changes the fingerprint, so stale plans are never
served.  Persistence is best-effort: an unwritable directory leaves a
process-local memory cache.  The file and its variable
(``REPRO_TORCH_TUNEPLANS``) are the port's own: the reference's
``runs/tuneplans.json`` holds plans with other fields and fingerprints.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional, Tuple

from repro_torch.core.memmodel import H100, HopperSpec
from repro_torch.tune.plan import KernelPlan, derive_plan, plan_key

DEFAULT_PATH = os.path.join("runs", "tuneplans_torch.json")
ENV_VAR = "REPRO_TORCH_TUNEPLANS"
_SCHEMA = 1


class PlanCache:
    """JSON-backed map ``plan_key -> KernelPlan``.

    ``path=None`` keeps the cache memory-only.  The file layout is
    ``{"schema_version": 1, "plans": {key: plan_dict}}``.
    """

    def __init__(self, path: Optional[str] = DEFAULT_PATH):
        self.path = path
        self._plans: Dict[str, KernelPlan] = {}
        self._loaded = path is None
        self._lock = threading.Lock()

    # -- persistence --------------------------------------------------------

    def _load(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        try:
            with open(self.path) as f:
                raw = json.load(f)
            for key, d in raw.get("plans", {}).items():
                self._plans[key] = KernelPlan.from_dict(d)
        except (OSError, ValueError, KeyError, TypeError, AttributeError):
            pass  # missing or corrupt file: start fresh

    def _save(self) -> None:
        if self.path is None:
            return
        if (self.path == DEFAULT_PATH
                and not os.path.isdir(os.path.dirname(self.path))):
            # the default path is relative to the working directory: outside
            # a checkout (no runs/ directory) a compute call writes nothing
            # and the cache stays memory-only; an explicit path is created
            return
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            tmp = f"{self.path}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"schema_version": _SCHEMA,
                           "plans": {k: p.to_dict()
                                     for k, p in sorted(self._plans.items())}},
                          f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, self.path)
        except OSError:
            pass  # read-only checkout: stay memory-only

    # -- access -------------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            self._load()
            return len(self._plans)

    def plans(self) -> Dict[str, KernelPlan]:
        with self._lock:
            self._load()
            return dict(self._plans)

    def get(self, key: str) -> Optional[KernelPlan]:
        with self._lock:
            self._load()
            return self._plans.get(key)

    def put(self, key: str, plan: KernelPlan) -> KernelPlan:
        with self._lock:
            self._load()
            self._plans[key] = plan
            self._save()
            return plan

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()
            self._loaded = self.path is None
            if self.path is not None:
                try:
                    os.remove(self.path)
                except OSError:
                    pass

    def get_or_derive(self, kernel: str, *, shape_sig: Tuple[int, ...],
                      dtype: str, spec: Optional[HopperSpec] = None,
                      calibration=None) -> KernelPlan:
        eff_spec = calibration.spec if calibration is not None else (spec or H100)
        key = plan_key(kernel, shape_sig, dtype, eff_spec)
        plan = self.get(key)
        if plan is None:
            plan = derive_plan(kernel, shape_sig=shape_sig, dtype=dtype,
                               spec=spec, calibration=calibration)
            self.put(key, plan)
        return plan


# ---------------------------------------------------------------------------
# process-default cache + the one-call lookup the kernels use
# ---------------------------------------------------------------------------

_default: Optional[PlanCache] = None
_default_lock = threading.Lock()


def default_cache() -> PlanCache:
    """Lazy singleton over ``$REPRO_TORCH_TUNEPLANS`` or
    ``runs/tuneplans_torch.json``."""
    global _default
    with _default_lock:
        if _default is None:
            _default = PlanCache(os.environ.get(ENV_VAR, DEFAULT_PATH))
        return _default


def set_default_cache(cache: Optional[PlanCache]) -> None:
    """Swap the process-default cache (tests; memory-only runs); ``None``
    makes the next :func:`default_cache` read the variable again."""
    global _default
    with _default_lock:
        _default = cache


def plan_for(kernel: str, *, shape_sig: Tuple[int, ...], dtype: str = "bfloat16",
             spec: Optional[HopperSpec] = None, calibration=None) -> KernelPlan:
    """The kernels' entry point: the cached plan for one call site.

    Shape signatures per kernel:
      flash_attention   (sq, skv, head_dim)
      decode_attention  (cache_len, head_dim)
      paged_attention   (max_len, head_dim)   -- plan.page_size shapes the pool
      paged_verify      (verify_tokens, max_len, head_dim)
      matmul            (m, n, k)
    """
    return default_cache().get_or_derive(kernel, shape_sig=shape_sig,
                                         dtype=dtype, spec=spec,
                                         calibration=calibration)
