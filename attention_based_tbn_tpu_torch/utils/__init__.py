"""Host-side helpers: device selection, metrics, logging, eval restore and
the challenge JSON."""
