"""Device kernels (XLA): match popcount, top-k, minimizers, chain, align."""
