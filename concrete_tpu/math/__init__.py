"""Exact integer math for the discretized torus: modular arithmetic,
negacyclic NTT over NTT-friendly primes, CRT reconstruction, and signed
gadget decomposition. The NTT runs in u32 Montgomery lanes."""
