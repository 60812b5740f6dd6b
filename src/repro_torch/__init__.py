"""PyTorch/CUDA port of the RapidRAID system (see ``repro`` for the JAX reference)."""
