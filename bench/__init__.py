"""The port's benchmark: ``python bench/run.py --workload <cell> ...``
(see ``bench/README.md``)."""
