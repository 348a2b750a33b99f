"""Cross-cutting infrastructure: logging, results/timing, RNG, errors.

Counterpart of the reference's src/Common/ infra layer (L1 in
SURVEY.md §1).
"""
