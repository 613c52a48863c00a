"""CPU tests of the benchmark (``test_perfbench_*.py``): its inputs, its
arithmetic, its reference against the port, its import boundary, and that
``correct`` comes out false for the control and for planted faults."""
