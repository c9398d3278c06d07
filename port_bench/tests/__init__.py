"""CPU tests of the benchmark (and one that needs the card, marked gpu):
``python -m pytest port_bench/tests -q`` from the repository's root."""
