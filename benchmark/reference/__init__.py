"""Plain PyTorch references of what the benchmark's cells train: the two
model families' QUBO builders, moment estimators, updates and predictions
(``dqbm``, ``cdqbm``), and the annealers their samplers stand for
(``anneal``).  They import nothing of the program and take nothing it has
made: inputs and weights come from the harness."""
