"""The model's operations a second over the card's peak in the
configuration's dtype, in % (`readers.mfu`)."""

from gpubench.readers import mfu as read  # noqa: F401
