"""Host image transport."""
