"""Cloud provider managers. Importing the package registers every provider
the JAX package registers (``mock``, ``docker-mock``, ``docker``,
``ec2-fleet``, ``ec2-ondemand``, ``static``) with the manager factory
(reference cloud/cloud.go:147-177 GetManager switch)."""
from . import manager  # noqa: F401
from . import docker  # noqa: F401
from . import ec2_fleet  # noqa: F401
from . import mock  # noqa: F401
from . import static  # noqa: F401
from .manager import CloudManager, get_manager, register_manager  # noqa: F401
