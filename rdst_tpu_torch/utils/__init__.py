from rdst_tpu_torch.utils.trace import work_profiles, work_profiles_enabled, profile_to

__all__ = ["work_profiles", "work_profiles_enabled", "profile_to"]
