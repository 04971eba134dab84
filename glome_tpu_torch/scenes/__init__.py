from .testscene import test_scene, simple_scene
from .meshscene import mesh_scene
