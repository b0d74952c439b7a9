"""Exchange schedules: the round structure and the registry's pricing."""
