"""Full training-state checkpoints (counterpart of ``qbmx.utils.checkpoint``).

A checkpoint is one ``.npz``: the parameter leaves under ``param:<key>``,
with ``qbmx``'s key names (``.b_h``, ``.w_seq/[0]``: the leaf's path in
the parameter tree), the model's ``torch.Generator`` state under
``torch_rng_state``, and a JSON ``meta_json`` (epoch, history, model
class, ``mid_epoch`` stamp, flatline-recovery attempt).  Resuming from it
continues the run exactly: the same parameters, the same random stream,
the same history.  One format for every model with a parameter dataclass
and a ``generator``: ``DiscQBM``, ``CDQBM`` and ``ClassificationRBM``
(whose keys are ``.weights``, ``.visible_bias``, ``.hidden_bias``,
``.class_bias``, ``.class_weights``).

The random stream does not cross packages: ``qbmx`` stores a jax key
(``rng_key``), the port a torch Generator state, and no bridge maps one to
the other.  Parameters, history and epoch do cross, both ways: the
``param:`` keys are the same, and :func:`load_checkpoint_params` reads
them from a ``qbmx``-written checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from qbmx_torch.utils.metrics import History

RNG_KEY = "torch_rng_state"


def _leaves_with_keys(params):
    """(key, tensor) for every leaf of a parameter dataclass, in field order:
    ``.<field>`` for a tensor, ``.<field>/[i]`` for a tuple's i-th (the
    ``str`` of jax's key path, as ``qbmx``'s ``_flatten_params`` writes it);
    an absent (``None``) field has no leaf."""
    for f in dataclasses.fields(params):
        value = getattr(params, f.name)
        if isinstance(value, tuple):
            for i, leaf in enumerate(value):
                yield f".{f.name}/[{i}]", leaf
        elif value is not None:
            yield f".{f.name}", value


def flatten_params(params) -> dict:
    """``{key: numpy array}`` of every parameter leaf (``qbmx``'s
    ``_flatten_params``)."""
    return {k: leaf.detach().cpu().numpy() for k, leaf in _leaves_with_keys(params)}


def save_checkpoint(path, model, history: History | None = None, epoch: int = 0,
                    mid_epoch: bool = False) -> None:
    """Write ``model``'s full state to ``path`` (``.npz`` appended).
    ``mid_epoch=True`` stamps a crash snapshot whose parameters may already
    have moved into the epoch after ``epoch``: :func:`load_checkpoint`
    refuses it unless asked to accept that."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {f"param:{k}": v for k, v in flatten_params(model.params).items()}
    arrays[RNG_KEY] = model.generator.get_state().numpy()
    meta = {
        "epoch": int(epoch),
        "history": dataclasses.asdict(history) if history is not None else None,
        "model_class": type(model).__name__,
        "mid_epoch": bool(mid_epoch),
        # the flatline-recovery counter: a resumed run continues at the next
        # attempt instead of re-drawing a basin that already flatlined
        "reinit_attempt": int(getattr(model, "_reinit_attempt", 0)),
    }
    meta_bytes = json.dumps(meta, default=lambda o: o.item()).encode()
    arrays["meta_json"] = np.frombuffer(meta_bytes, dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def _read(path, model, allow_mid_epoch: bool):
    """(npz data, meta, params read into ``model``'s tree), with ``qbmx``'s
    refusals: another model class, a ``mid_epoch`` snapshot without the
    opt-in, a missing key, a shape mismatch."""
    path = str(path)
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    meta = json.loads(bytes(data["meta_json"]).decode())
    saved_cls = meta.get("model_class")
    if saved_cls is not None and saved_cls != type(model).__name__:
        raise ValueError(f"checkpoint was saved from {saved_cls}, not {type(model).__name__}")
    if meta.get("mid_epoch") and not allow_mid_epoch:
        raise ValueError(
            f"{path} is a mid-epoch crash snapshot: its params may already be partially "
            "advanced into the crashed epoch, so resuming from it double-trains part of an "
            "epoch. Resume from the last periodic checkpoint, or pass allow_mid_epoch=True "
            "to accept the skew.")
    leaves = {}
    for key, leaf in _leaves_with_keys(model.params):
        name = f"param:{key}"
        if name not in data.files:
            raise KeyError(f"checkpoint missing parameter {key}")
        arr = data[name]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(leaf.shape)}")
        leaves[key] = torch.tensor(arr, dtype=leaf.dtype, device=leaf.device)

    def rebuild(f, value):
        if isinstance(value, tuple):
            return tuple(leaves[f".{f.name}/[{i}]"] for i in range(len(value)))
        return None if value is None else leaves[f".{f.name}"]

    params = type(model.params)(**{f.name: rebuild(f, getattr(model.params, f.name))
                                   for f in dataclasses.fields(model.params)})
    return data, meta, params


def _history(meta) -> History | None:
    h = meta.get("history")
    if h is None:
        return None
    return History(**{k: h.get(k, []) for k in History.__dataclass_fields__})


def load_checkpoint(path, model, allow_mid_epoch: bool = False) -> tuple[History | None, int]:
    """Restore parameters, random stream and flatline-recovery attempt into
    ``model`` in place; returns (history, completed epochs).  Refuses
    another model class, a ``mid_epoch`` crash snapshot unless
    ``allow_mid_epoch=True``, a missing key, a shape mismatch, and a
    checkpoint written by ``qbmx`` (a jax key, no torch Generator state:
    :func:`load_checkpoint_params` reads its parameters)."""
    data, meta, params = _read(path, model, allow_mid_epoch)
    if RNG_KEY not in data.files:
        raise ValueError(
            f"{path} holds no torch Generator state"
            + (" (a qbmx checkpoint: its random stream is a jax key)" if "rng_key" in data.files
               else "")
            + ": it cannot resume the run exactly; load_checkpoint_params reads its "
            "params, history and epoch")
    model.params = params
    model.generator.set_state(torch.as_tensor(data[RNG_KEY]))
    model._reinit_attempt = int(meta.get("reinit_attempt", 0))
    return _history(meta), int(meta.get("epoch", 0))


def load_checkpoint_params(path, model,
                           allow_mid_epoch: bool = False) -> tuple[History | None, int]:
    """Restore only the parameters into ``model`` (its random stream stays
    as it is); returns (history, completed epochs).  Reads checkpoints of
    both packages, with :func:`load_checkpoint`'s refusals otherwise."""
    _, meta, params = _read(path, model, allow_mid_epoch)
    model.params = params
    return _history(meta), int(meta.get("epoch", 0))
