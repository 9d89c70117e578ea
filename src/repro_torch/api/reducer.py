"""``Reducer``: one fit/transform/save/load interface for every DR method.

The paper's RAE (``core.trainer`` + ``core.rae``) and the five Table 1
baselines (``core.baselines``: PCA, RP, MDS, Isomap, UMAP) share one
protocol and one string registry, so the index factory never special-cases
the method. ``transform`` returns a float32 tensor on the reducer's
``device``.

Persistence layout (one directory per reducer), the reference's own, so a
directory either package saved loads in the other::

    <dir>/meta.json     # {"kind": ..., "config" (RAE) or "state" (baselines)}
    <dir>/arrays.npz    # fitted numpy state (weights, train embeddings, ...)

``load_reducer(dir)`` dispatches on ``meta.json["kind"]``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Callable, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from ..configs import RAEConfig
from ..core import baselines, trainer
from ..kernels.rae_encode import rae_encode

_META = "meta.json"
_ARRAYS = "arrays.npz"


@runtime_checkable
class Reducer(Protocol):
    """Dimensionality reduction map R^n -> R^m."""

    kind: str
    out_dim: int

    @property
    def fitted(self) -> bool: ...

    def fit(self, train_x: np.ndarray) -> "Reducer": ...

    def transform(self, x) -> torch.Tensor: ...

    def fingerprint(self) -> str: ...

    def save(self, directory: str) -> None: ...


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REDUCERS: dict[str, Callable[..., Reducer]] = {}


def register_reducer(name: str):
    """Class decorator: register under ``name`` (lowercase canonical)."""

    def deco(cls):
        _REDUCERS[name.lower()] = cls
        cls.kind = name.lower()
        return cls

    return deco


def get_reducer(name: str) -> Callable[..., Reducer]:
    try:
        return _REDUCERS[name.lower()]
    except KeyError:
        raise KeyError(
            f"unknown reducer {name!r}; known: {sorted(_REDUCERS)}") from None


def list_reducers() -> list[str]:
    return sorted(_REDUCERS)


def make_reducer(name: str, out_dim: int, **kw) -> Reducer:
    return get_reducer(name)(out_dim=out_dim, **kw)


def load_reducer(directory: str, device: str | torch.device = "cuda"
                 ) -> Reducer:
    with open(os.path.join(directory, _META)) as f:
        meta = json.load(f)
    cls = get_reducer(meta["kind"])
    return cls._load(directory, meta, device)


def _save_meta(directory: str, meta: dict[str, Any]) -> None:
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, _META), "w") as f:
        json.dump(meta, f, indent=1)


def as_device_tensor(x, device: str | torch.device) -> torch.Tensor:
    """float32 tensor on ``device`` from a numpy array or a tensor (no copy
    when it already is one)."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Baseline adapters
# ---------------------------------------------------------------------------
class _BaselineReducer:
    """Adapter over a ``core.baselines`` dataclass. Fitted state lives in the
    wrapped dataclass; persistence splits its fields into json scalars and
    npz arrays generically (the reference's split), so every baseline
    round-trips with no per-class code and either package loads the other's
    directory with the same fingerprint."""

    _impl_cls: type

    def __init__(self, out_dim: int, device: str | torch.device = "cuda",
                 **kw):
        self._impl = self._impl_cls(out_dim=out_dim, **kw)
        self._fitted = False
        self.device = torch.device(device)

    @property
    def out_dim(self) -> int:
        return self._impl.out_dim

    @property
    def fitted(self) -> bool:
        return self._fitted

    def _fit_impl(self, train_x: np.ndarray) -> None:
        self._impl.fit(train_x)

    def fit(self, train_x) -> "_BaselineReducer":
        if isinstance(train_x, torch.Tensor):
            train_x = train_x.detach().cpu().numpy()
        self._fit_impl(np.asarray(train_x, np.float32))
        self._fitted = True
        return self

    def transform(self, x) -> torch.Tensor:
        if not self._fitted:
            raise RuntimeError(f"{self.kind}: transform before fit")
        return self._impl.transform(as_device_tensor(x, self.device))

    def fingerprint(self) -> str:
        """Content hash of the fitted map: every field of the wrapped
        dataclass with the same scalar/array split ``save`` uses (the
        reference's bytes)."""
        if not self._fitted:
            raise RuntimeError(f"{self.kind}: fingerprint before fit")
        h = hashlib.sha1(self.kind.encode())
        for f in dataclasses.fields(self._impl):
            v = getattr(self._impl, f.name)
            h.update(f.name.encode())
            if v is None or isinstance(v, (bool, int, float, str)):
                h.update(str(v).encode())
            else:
                a = np.asarray(v)
                h.update(f"{a.shape}:{a.dtype}".encode())
                h.update(a.tobytes())
        return h.hexdigest()[:16]

    def save(self, directory: str) -> None:
        scalars: dict[str, Any] = {}
        arrays: dict[str, np.ndarray] = {}
        for f in dataclasses.fields(self._impl):
            v = getattr(self._impl, f.name)
            if v is None or isinstance(v, (bool, int, float, str)):
                scalars[f.name] = v
            else:
                arrays[f.name] = np.asarray(v)
        _save_meta(directory, {"kind": self.kind, "state": scalars,
                               "fitted": self._fitted})
        np.savez(os.path.join(directory, _ARRAYS), **arrays)

    @classmethod
    def _load(cls, directory: str, meta: dict[str, Any],
              device: str | torch.device):
        self = cls.__new__(cls)
        state = dict(meta["state"])
        with np.load(os.path.join(directory, _ARRAYS)) as z:
            state.update({k: z[k] for k in z.files})
        self._impl = cls._impl_cls(**state)
        self._fitted = bool(meta.get("fitted", True))
        self.device = torch.device(device)
        return self


@register_reducer("pca")
class PCAReducer(_BaselineReducer):
    _impl_cls = baselines.PCA


@register_reducer("rp")
class GaussianRPReducer(_BaselineReducer):
    _impl_cls = baselines.GaussianRP


@register_reducer("mds")
class MDSLinearReducer(_BaselineReducer):
    _impl_cls = baselines.MDSLinear


@register_reducer("isomap")
class IsomapReducer(_BaselineReducer):
    """Its geodesics' min-plus squaring runs on the reducer's device."""

    _impl_cls = baselines.Isomap

    def _fit_impl(self, train_x: np.ndarray) -> None:
        self._impl.fit(train_x, device=self.device)


@register_reducer("umap")
class UMAPLiteReducer(_BaselineReducer):
    _impl_cls = baselines.UMAPLite


# ---------------------------------------------------------------------------
# RAE
# ---------------------------------------------------------------------------
@register_reducer("rae")
class RAEReducer:
    """The paper's RAE behind the reducer interface.

    ``fit`` runs the trainer (``core.trainer``) on ``device``;
    ``transform`` is the trained encoder f(x) = x W_e through the
    ``rae_encode`` op (the hand-written kernel on the card) and returns a
    float32 tensor on ``device``. ``in_dim`` is taken from the training
    data, so construction needs only ``out_dim``.
    """

    def __init__(self, out_dim: int, *, steps: int = 3000,
                 weight_decay: float = 1e-2, seed: int = 0,
                 batch_size: int = 128, lr_max: float = 1e-3,
                 lr_min: float = 1e-5, explicit_frobenius: bool = False,
                 log_every: int = 10 ** 9,
                 device: str | torch.device = "cuda"):
        self.out_dim = out_dim
        self.steps = steps
        self.weight_decay = weight_decay
        self.seed = seed
        self.batch_size = batch_size
        self.lr_max = lr_max
        self.lr_min = lr_min
        self.explicit_frobenius = explicit_frobenius
        self.log_every = log_every
        self.device = torch.device(device)
        self.params_: Optional[dict[str, torch.Tensor]] = None
        self.cfg_: Optional[RAEConfig] = None
        self.history_: list[dict[str, float]] = []

    @property
    def fitted(self) -> bool:
        return self.params_ is not None

    def _make_cfg(self, in_dim: int) -> RAEConfig:
        return RAEConfig(in_dim=in_dim, out_dim=self.out_dim,
                         steps=self.steps, weight_decay=self.weight_decay,
                         seed=self.seed, batch_size=self.batch_size,
                         lr_max=self.lr_max, lr_min=self.lr_min,
                         explicit_frobenius=self.explicit_frobenius)

    def fit(self, train_x: np.ndarray) -> "RAEReducer":
        if isinstance(train_x, torch.Tensor):
            train_x = train_x.detach().cpu().numpy()
        train_x = np.asarray(train_x, np.float32)
        self.cfg_ = self._make_cfg(train_x.shape[1])
        res = trainer.train(self.cfg_, train_x, log_every=self.log_every,
                            device=self.device)
        self.params_ = res.params
        self.history_ = res.history
        return self

    def transform(self, x) -> torch.Tensor:
        if self.params_ is None:
            raise RuntimeError("rae: transform before fit")
        z = rae_encode(as_device_tensor(x, self.device), self.params_["w_e"],
                       normalize=False)
        if "b_e" in self.params_:  # the kernel takes no bias
            z = z + self.params_["b_e"]
        return z

    def fingerprint(self) -> str:
        """Content hash of the trained encoder (config + weights); the same
        bytes as the reference's for the same state."""
        if self.params_ is None:
            raise RuntimeError("rae: fingerprint before fit")
        h = hashlib.sha1(self.kind.encode())
        if self.cfg_ is not None:
            h.update(json.dumps(dataclasses.asdict(self.cfg_),
                                sort_keys=True).encode())
        for k in sorted(self.params_):
            a = self.params_[k].detach().cpu().numpy()
            h.update(f"{k}:{a.shape}:{a.dtype}".encode())
            h.update(a.tobytes())
        return h.hexdigest()[:16]

    def save(self, directory: str) -> None:
        if self.params_ is None:
            raise RuntimeError("rae: save before fit")
        cfg = dataclasses.asdict(self.cfg_)
        _save_meta(directory, {"kind": self.kind, "config": cfg,
                               "history_tail": self.history_[-1:]})
        np.savez(os.path.join(directory, _ARRAYS),
                 **{k: v.detach().cpu().numpy()
                    for k, v in self.params_.items()})

    @classmethod
    def _load(cls, directory: str, meta: dict[str, Any],
              device: str | torch.device) -> "RAEReducer":
        cfg = RAEConfig(**meta["config"])
        self = cls(out_dim=cfg.out_dim, steps=cfg.steps,
                   weight_decay=cfg.weight_decay, seed=cfg.seed,
                   batch_size=cfg.batch_size, lr_max=cfg.lr_max,
                   lr_min=cfg.lr_min,
                   explicit_frobenius=cfg.explicit_frobenius, device=device)
        self.cfg_ = cfg
        with np.load(os.path.join(directory, _ARRAYS)) as z:
            self.params_ = {k: torch.as_tensor(z[k], device=self.device)
                            for k in z.files}
        self.history_ = list(meta.get("history_tail", []))
        return self
