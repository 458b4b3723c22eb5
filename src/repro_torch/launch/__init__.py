"""Launch-time policies and CLIs (mirror of ``repro.launch``): the render
and production meshes (``mesh.py``), the render, serve and gateway CLIs,
the LM serve loop and CLI (``serve.py``), the LM step functions
(``steps.py``), the LM training loop and CLI (``train.py``), and the dry
run on the ``meta`` device (``shapes.py``, ``roofline.py``, ``dryrun.py``,
``meminspect.py``, ``report.py``)."""
