"""Exact TFHE arithmetic: the numpy oracle, keygen, limbs, torch kernels."""
