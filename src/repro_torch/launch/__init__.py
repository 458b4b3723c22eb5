"""Launch-time policies and CLIs (mirror of ``repro.launch``): the render
mesh (``mesh.py``), the render, serve and gateway CLIs, and the LM serve
loop and CLI (``serve.py``)."""
