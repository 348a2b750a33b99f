"""Vectorized compute kernels: hashing, generators, sort, merge, partition.

Counterpart of the reference's hot loops (L4/L5 in SURVEY.md §1):
pointer-chasing hash tables and per-thread scalar loops become data-parallel
JAX programs.
"""
