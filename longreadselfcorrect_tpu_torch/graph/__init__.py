"""Assembly string-graph layer (SQG / Bigraph / StringGraph re-design).

Host-side graph machinery — the reference keeps assembly on the CPU too
(Bigraph/, StringGraph/, SQG/); the FM-index heavy lifting (overlap
discovery, illegal-kmer checks) runs through the same batched index kernels
as the rest of the framework.
"""
