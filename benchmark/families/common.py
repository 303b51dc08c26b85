"""The users' training entries over a built model or sweep, shared by the
families."""

from __future__ import annotations

from qbmx_torch.train.loop import train_model
from qbmx_torch.utils.metrics import History


def seed_list(seed: int, count: int) -> list[int]:
    """The program's seeds of a run: ``count`` from ``seed``, each in
    [0, 2³²) as the models take them."""
    return [(int(seed) + i) % 2**32 for i in range(count)]


def single_epoch(model, t: dict, parts: dict):
    """Epoch e of a single model through ``train_model``, validation
    included, continuing one history."""
    history = History()

    def epoch(e: int, warm: bool) -> None:
        tx, ty, vx, vy = parts["warm" if warm else "full"]
        train_model(model, tx, ty, vx, vy, batch_size=t["batch"],
                    learning_rate=t["learning_rate"], epochs=e, start_epoch=e - 1,
                    history=history, save_folder=None, verbose=False)

    return epoch


def sweep_epoch(sweep, t: dict, parts: dict, **kw):
    """One epoch of a seed sweep through ``train``, validation included;
    the sweep keeps its state between calls."""

    def epoch(e: int, warm: bool) -> None:
        tx, ty, vx, vy = parts["warm" if warm else "full"]
        sweep.train(tx, ty, vx, vy, epochs=1, batch_size=t["batch"],
                    learning_rate=t["learning_rate"], verbose=False, **kw)

    return epoch
