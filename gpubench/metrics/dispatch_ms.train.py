"""Mean host ms inside each call of the timed entry (`readers.dispatch_ms`)."""

from gpubench.readers import dispatch_ms as read  # noqa: F401
