"""How the harness builds each model family of the program: one module a
family, named by a configuration's ``family``, with ``build(cfg, mix,
seed, data, weights, device) -> cell.Cell``."""
