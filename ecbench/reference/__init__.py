"""The plain reference the benchmark judges the port against.

NumPy and plain PyTorch only; nothing here imports the port, the JAX
package or JAX. Every matrix and table is worked out here from the
published constructions:

- `gf`: GF(2^8) over the polynomial 0x11D (generator 2), linear solves,
  and a matrix apply computed as a 0/1 float32 matrix product on the
  bit planes (exact: sums stay below 2**24).
- `codes`: the Reed-Solomon coding matrix (Plank's Vandermonde
  construction, column-reduced to systematic form) and the Clay code
  (Vajha et al., FAST 2018) as a generator over sub-chunks, with the
  single-chunk repair matrix of its repair planes.
- `crc`: CRC-32C (Castagnoli, reflected 0x82F63B78) of byte rows, in
  chunks combined by the GF(2) shift matrices.
"""
