"""The benchmark of the PyTorch/CUDA port (``svi_mapper_tpu_torch``).

``BENCHMARK.json`` at the checkout's root names its cells and metrics; one
run of one cell is ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. Everything that belongs to one
configuration, traffic mix, metric or cell is a file found by name
(``portbench.manifest``). The frozen yardstick lives here too: the
generator (``segments``), the plain reference (``reference/``), the work
formulas and peaks (``work/``) and the limits (``limits/``). It imports
nothing of JAX or of the JAX package. ``python3 -m pytest portbench/tests``
runs its tests; those marked ``gpu`` need the card.
"""
