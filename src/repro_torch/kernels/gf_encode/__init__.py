"""Pipelined GF(2^l) encode and decode ticks: CUDA kernels, plain versions, ops."""
