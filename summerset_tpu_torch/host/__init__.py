"""Host-side planes of the port (the codeword payload store)."""
