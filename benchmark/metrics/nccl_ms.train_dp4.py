"""Rank 0's device ms a step summing the gradients over the data group
(parallel/mesh.py:Mesh.sum_grads: the NCCL all-reduce and the copies
around it): the card's busy time on work launched inside the program
span `vcvits.train.grad_sum`, a step (`vcvits.train.step`;
benchmark/program_spans.py). The all-reduce's time includes its wait for
the slowest rank."""

from benchmark.program_spans import busy_ms


def read(rec):
    return busy_ms(rec, ["train.grad_sum"], "train.step")
