"""The plain references that decide ``correct`` (torch only; nothing of the
program under test)."""
