"""Hand-written device code.

  linalg.py       fixed-cost batched small-matrix linear algebra (Cholesky,
                  inverse iteration) used by the estimation hot paths
  pallas_fast.py  fused FAST corner response through Pallas' Triton route;
                  frontend.fast.score_batch picks it on a GPU
"""
