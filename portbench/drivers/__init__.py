"""One driver for each kind of traffic mix: ``serve`` and ``train``."""
