"""Apps whose per-rank programs the port profiles (kripke so far)."""
