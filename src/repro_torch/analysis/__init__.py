"""What one step costs on one card: the step's counted work
(``costs``), its roofline (``roofline``) and comparisons of two runs
(``perf_compare``)."""
