"""Model layers of the port. Importing the package registers the
architectures the serving slice resolves from ``config.cfg``."""

from . import heads, transformer  # noqa: F401
