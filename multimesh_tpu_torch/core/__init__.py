"""GLL basis and element shape maps (torch)."""
