"""The JAX package's two EMD workloads (``configs/emd_20news.py`` and
``configs/emd_mnist.py``), the shapes the port is run at."""
