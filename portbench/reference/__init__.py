"""Plain reference of the benchmarked semantics, in NumPy and plain PyTorch.

It imports nothing of the program under test: the code graph, the trials of
a point, the a-priori LLRs, the syndromes and the flooding sum-product
decode are all worked out again here from the configuration and the seed,
so that a run's answers can be judged against them.
"""
