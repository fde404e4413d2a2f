"""Host utilities (the ChaCha20 CSPRNG)."""
