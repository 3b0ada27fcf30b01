from vlite_fast.runtime import trigger, control, capture, dumper  # noqa: F401

