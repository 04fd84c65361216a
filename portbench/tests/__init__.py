"""CPU tests of the benchmark (``pytest portbench/tests``); ``-m gpu`` runs
the card's."""
