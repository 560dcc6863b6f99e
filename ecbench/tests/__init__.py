"""Tests of the benchmark: CPU tests at tiny sizes, and card tests
(marked `card`) that skip without CUDA. Run them with
`python -m pytest ecbench/tests -q`."""
