from .testscene import test_scene, simple_scene
