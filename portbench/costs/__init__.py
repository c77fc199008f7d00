"""What the chip could do at best: peaks, kernel operations and bytes, model FLOPs."""
