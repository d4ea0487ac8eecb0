"""The benchmark's own CPU tests (and its card-only ones, skipped without a card)."""
