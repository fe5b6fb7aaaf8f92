"""Model layers of the port. Importing the package registers the
architectures the pipeline resolves from ``config.cfg``."""

from . import heads, transformer  # noqa: F401
