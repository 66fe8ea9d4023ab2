"""Share of the traced window with no device operation running, in %
(`readers.idle_share`)."""

from gpubench.readers import idle_share as read  # noqa: F401
