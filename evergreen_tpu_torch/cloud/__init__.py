"""Cloud provider managers. Importing the package registers the ported
providers with the manager factory (``cloud/mock.py``: ``mock`` and
``docker-mock``), as the JAX package's import registers all of its own."""
from . import manager  # noqa: F401
from . import mock  # noqa: F401
