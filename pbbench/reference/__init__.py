"""The plain reference that decides a run's ``correct``.

A frozen copy of the host ``SelfCorrector`` of the PyTorch port and the
numpy modules it needs (``core/{correct,seeds,extend,msa,overlapper,itree,
threshold,alphabet}.py`` and ``index/host.py``), with the device routes of
the MSA fallback taken out: every loop runs in numpy.  It imports nothing of
the port or of the JAX package, and it reads its index from the raw BWT
files that ``native/fmbuild`` writes (``tables.py``), never from the port's
pack.  A change to the port does not change this copy.
"""
