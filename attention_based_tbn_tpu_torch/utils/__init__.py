"""Host-side helpers: device and platform keys, metrics, logging, eval
restore and the challenge JSON."""
