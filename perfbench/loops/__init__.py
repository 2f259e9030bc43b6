"""Load generators, one module per ``"loop"`` kind of a traffic mix."""
