"""Host-side helpers: modality resolution and device selection."""
