"""Host utilities (the ChaCha20 CSPRNG, the device rule)."""
