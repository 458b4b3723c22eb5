"""Launch-time policies and CLIs (mirror of ``repro.launch``): the render
mesh (``mesh.py``) and the render, serve and gateway CLIs."""
