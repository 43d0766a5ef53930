"""The traffic loops: ``bench/loops/<loop>.py`` for each ``"loop"`` a
traffic file of ``bench/traffic/`` names."""
