"""Launch-time policies and CLIs (mirror of ``repro.launch``): the render
mesh (``mesh.py``), the render, serve and gateway CLIs, the LM serve loop
and CLI (``serve.py``), the LM step functions (``steps.py``) and the LM
training loop and CLI (``train.py``)."""
